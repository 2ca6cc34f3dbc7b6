// PyTorch binding of the port's kernels (sha256_pairs.cu, sha256_gather.cu,
// epoch_sweep.cu), for torch.utils.cpp_extension.load.  The one file of the
// port that includes PyTorch's headers.  The Python wrappers
// (ops/sha256_cuda.py, ops/epoch_sweep_cuda.py) check shape, dtype, device,
// contiguity, alignment and offsets before they call in.

#include <torch/extension.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

extern "C" int sha256_pairs_launch(const void* in, void* out, int64_t n_pairs,
                                   void* stream);
extern "C" int sha256_gather_launch(void* pool, const void* idx_l,
                                    const void* idx_r, int64_t out_offset,
                                    int64_t n_pairs, void* stream);
extern "C" int epoch_sweep_launch(const int64_t* params, int* launched,
                                  void* stream);

// out[i] = SHA-256(chunks[2i] || chunks[2i + 1]), on the current stream.
void sha256_pairs(const torch::Tensor& chunks, torch::Tensor out) {
  const c10::cuda::CUDAGuard guard(chunks.device());
  const int rc = sha256_pairs_launch(
      chunks.data_ptr(), out.data_ptr(), out.size(0),
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
}

// pool[out_offset + i] = SHA-256(pool[idx_l[i]] || pool[idx_r[i]]), on the
// current stream.
void sha256_gather(torch::Tensor pool, const torch::Tensor& idx_l,
                   const torch::Tensor& idx_r, int64_t out_offset) {
  const c10::cuda::CUDAGuard guard(pool.device());
  const int rc = sha256_gather_launch(
      pool.data_ptr(), idx_l.data_ptr(), idx_r.data_ptr(), out_offset,
      idx_l.size(0), c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
}

// One epoch sweep on the current stream of `like`'s card.  `params` is the
// host int64 array of epoch_sweep.cu's Param slots (device addresses,
// sizes, switches and values); returns the number of kernels launched.
int64_t epoch_sweep(const torch::Tensor& params, const torch::Tensor& like) {
  const c10::cuda::CUDAGuard guard(like.device());
  int launched = 0;
  const int rc = epoch_sweep_launch(
      params.data_ptr<int64_t>(), &launched,
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
  return launched;
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("sha256_pairs", &sha256_pairs, "SHA-256 of each 64-byte chunk pair");
  m.def("sha256_gather", &sha256_gather,
        "SHA-256 of chunk pairs gathered by index, written in place");
  m.def("epoch_sweep", &epoch_sweep,
        "the per-validator epoch sweep, up to three launches");
}
