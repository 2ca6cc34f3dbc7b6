// PyTorch binding of sha256_pairs.cu, for torch.utils.cpp_extension.load.
// The one file of the port that includes PyTorch's headers.  The Python
// wrapper (ops/sha256_cuda.py) checks shape, dtype, device, contiguity and
// alignment before it calls in.

#include <torch/extension.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

extern "C" int sha256_pairs_launch(const void* in, void* out, int64_t n_pairs,
                                   void* stream);

// out[i] = SHA-256(chunks[2i] || chunks[2i + 1]), on the current stream.
void sha256_pairs(const torch::Tensor& chunks, torch::Tensor out) {
  const c10::cuda::CUDAGuard guard(chunks.device());
  const int rc = sha256_pairs_launch(
      chunks.data_ptr(), out.data_ptr(), out.size(0),
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("sha256_pairs", &sha256_pairs, "SHA-256 of each 64-byte chunk pair");
}
