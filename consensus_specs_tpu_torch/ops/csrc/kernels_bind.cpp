// PyTorch binding of the port's kernels (sha256_pairs.cu, sha256_gather.cu,
// epoch_sweep.cu, bls381_g2.cu, bls381_field.cu, bls381_msm.cu,
// bls381_fold.cu, bls381_cofactor.cu, bls381_check.cu with the pairing's
// two launches and the segment sums, bls381_pippenger.cu), for
// torch.utils.cpp_extension.load.  The one file of the port that includes
// PyTorch's headers.  The Python wrappers (ops/sha256_cuda.py,
// ops/epoch_sweep_cuda.py, ops/bls381_cuda.py) check shape, dtype, device,
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
extern "C" int bls381_field_launch(int op, const void* a, const void* b,
                                   void* out, int64_t n, void* stream);
extern "C" int bls381_g2_ladder_launch(const void* pts, const void* bits,
                                       int64_t nbits, void* out, int64_t n,
                                       void* stream);
extern "C" int bls381_miller_launch(const void* g1, const void* g2,
                                    const void* skip, void* f, int64_t n,
                                    void* stream);
extern "C" int bls381_final_launch(const void* f, int64_t k, int do_final,
                                   void* prod, void* ok, int64_t b,
                                   void* stream);
extern "C" int bls381_segment_sum_launch(int g2, void* buf, int64_t len,
                                         void* out, int64_t segments,
                                         void* stream);
extern "C" int bls381_g1_ladder_launch(const void* pts, const void* bits,
                                       int64_t nbits, void* out, int64_t n,
                                       int split, void* stream);
extern "C" int bls381_fold_w_launch(const void* agg, const void* cbits,
                                    int64_t ncbits, const void* consts,
                                    void* g1, void* skip, int64_t k,
                                    void* stream);
extern "C" int bls381_fold_sw_launch(const void* sig, const void* cbits,
                                     int64_t ncbits, void* sw, int64_t k,
                                     void* stream);
extern "C" int bls381_fold_h_launch(const void* h_inf, const void* consts,
                                    void* g2, void* skip, int64_t k,
                                    void* stream);
extern "C" int bls381_fold_tail_launch(const void* S, const void* consts,
                                       void* g1, void* g2, void* skip,
                                       int64_t k, void* stream);
extern "C" int bls381_clear_cofactor_launch(const void* pts,
                                            const void* consts, void* xy,
                                            void* inf, int64_t n,
                                            void* stream);
extern "C" int bls381_pairing_check_launch(const void* g1, const void* g2,
                                           const void* skip, void* tq,
                                           void* prod, void* ok, int64_t k,
                                           int64_t b, void* stream);
extern "C" int bls381_pippenger_launch(
    const void* pts, const void* digits, int64_t n, void* idx, void* bstart,
    void* istart, void* item_bucket, void* partial, void* B, void* tbuf,
    void* T, void* G, void* out, int stage, void* stream);

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
// host int64 array of epoch_sweep.cuh's Param slots (device addresses,
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

// out = op(a, b) over n elements (bls381_field.cu); has_b false for a
// unary op, whose b is not read.
void bls381_field(int64_t op, const torch::Tensor& a, const torch::Tensor& b,
                  bool has_b, torch::Tensor out, int64_t n) {
  const c10::cuda::CUDAGuard guard(a.device());
  const int rc = bls381_field_launch(
      static_cast<int>(op), a.data_ptr(), has_b ? b.data_ptr() : nullptr,
      out.data_ptr(), n, c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
}

// The G2 ladder of n points over their bit rows (bls381_g2.cu).
void bls381_ladder(const torch::Tensor& pts, const torch::Tensor& bits,
                   int64_t nbits, torch::Tensor out, int64_t n) {
  const c10::cuda::CUDAGuard guard(pts.device());
  const int rc = bls381_g2_ladder_launch(
      pts.data_ptr(), bits.data_ptr(), nbits, out.data_ptr(), n,
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
}

// Launch 1 of the pairing: n Miller loops, a block each (bls381_check.cu,
// bodies in bls381_pairing.cuh).
void bls381_miller(const torch::Tensor& g1, const torch::Tensor& g2,
                   const torch::Tensor& skip, torch::Tensor f, int64_t n) {
  const c10::cuda::CUDAGuard guard(g1.device());
  const int rc = bls381_miller_launch(
      g1.data_ptr(), g2.data_ptr(), skip.data_ptr(), f.data_ptr(), n,
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
}

// Launch 2: b jobs' products of k Miller values, a block each, and their
// final exponentiation's is-one when do_final (bls381_check.cu).
void bls381_final(const torch::Tensor& f, int64_t k, bool do_final,
                  torch::Tensor prod, torch::Tensor ok, int64_t b) {
  const c10::cuda::CUDAGuard guard(f.device());
  const int rc = bls381_final_launch(
      f.data_ptr(), k, do_final ? 1 : 0, prod.data_ptr(), ok.data_ptr(), b,
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
}

// K1: the sums of `segments` segments of `len` points, in place in buf
// (bls381_msm.cu); g2 selects G2 points.
void bls381_segment_sum(bool g2, torch::Tensor buf, int64_t len,
                        torch::Tensor out, int64_t segments) {
  const c10::cuda::CUDAGuard guard(buf.device());
  const int rc = bls381_segment_sum_launch(
      g2 ? 1 : 0, buf.data_ptr(), len, out.data_ptr(), segments,
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
}

// K2: the G1 ladder of n points over their bit rows, GLV-split halves
// when split (bls381_msm.cu).
void bls381_g1_ladder(const torch::Tensor& pts, const torch::Tensor& bits,
                      int64_t nbits, torch::Tensor out, int64_t n,
                      bool split) {
  const c10::cuda::CUDAGuard guard(pts.device());
  const int rc = bls381_g1_ladder_launch(
      pts.data_ptr(), bits.data_ptr(), nbits, out.data_ptr(), n,
      split ? 1 : 0, c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
}

// K4's weighting leg: w = c agg of k sets, affine (bls381_fold.cu); skip
// must be zero before the legs.
void bls381_fold_w(const torch::Tensor& agg, const torch::Tensor& cbits,
                   int64_t ncbits, const torch::Tensor& consts,
                   torch::Tensor g1, torch::Tensor skip, int64_t k) {
  const c10::cuda::CUDAGuard guard(agg.device());
  const int rc = bls381_fold_w_launch(
      agg.data_ptr(), cbits.data_ptr(), ncbits, consts.data_ptr(),
      g1.data_ptr(), skip.data_ptr(), k,
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
}

// K4's signature leg: sw = c sig of k sets, Jacobian (bls381_fold.cu).
void bls381_fold_sw(const torch::Tensor& sig, const torch::Tensor& cbits,
                    int64_t ncbits, torch::Tensor sw, int64_t k) {
  const c10::cuda::CUDAGuard guard(sig.device());
  const int rc = bls381_fold_sw_launch(
      sig.data_ptr(), cbits.data_ptr(), ncbits, sw.data_ptr(), k,
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
}

// K4's cofactor leg after bls381_cofactor.cu: the G2 generator and skip
// where h_eff Q is infinity (bls381_fold.cu).
void bls381_fold_h(const torch::Tensor& h_inf, const torch::Tensor& consts,
                   torch::Tensor g2, torch::Tensor skip, int64_t k) {
  const c10::cuda::CUDAGuard guard(h_inf.device());
  const int rc = bls381_fold_h_launch(
      h_inf.data_ptr(), consts.data_ptr(), g2.data_ptr(), skip.data_ptr(), k,
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
}

// K4's last pair, at index k, from the sum S.
void bls381_fold_tail(const torch::Tensor& S, const torch::Tensor& consts,
                      torch::Tensor g1, torch::Tensor g2, torch::Tensor skip,
                      int64_t k) {
  const c10::cuda::CUDAGuard guard(S.device());
  const int rc = bls381_fold_tail_launch(
      S.data_ptr(), consts.data_ptr(), g1.data_ptr(), g2.data_ptr(),
      skip.data_ptr(), k, c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
}
// Kernel A: h_eff P of n G2 points by psi, affine (bls381_cofactor.cu).
void bls381_clear_cofactor(const torch::Tensor& pts,
                           const torch::Tensor& consts, torch::Tensor xy,
                           torch::Tensor inf, int64_t n) {
  const c10::cuda::CUDAGuard guard(pts.device());
  const int rc = bls381_clear_cofactor_launch(
      pts.data_ptr(), consts.data_ptr(), xy.data_ptr(), inf.data_ptr(), n,
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
}

// Kernel B: b pairing checks of k pairs, four warps a job (bls381_check.cu).
void bls381_pairing_check(const torch::Tensor& g1, const torch::Tensor& g2,
                          const torch::Tensor& skip, torch::Tensor tq,
                          torch::Tensor prod, torch::Tensor ok, int64_t k,
                          int64_t b) {
  const c10::cuda::CUDAGuard guard(g1.device());
  const int rc = bls381_pairing_check_launch(
      g1.data_ptr(), g2.data_ptr(), skip.data_ptr(), tq.data_ptr(),
      prod.data_ptr(), ok.data_ptr(), k, b,
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
}

// The Pippenger G1 MSM (bls381_pippenger.cu): launch `stage` (1-5) of
// one MSM of n points, or all five in order (stage 0), into out.
void bls381_pippenger(const torch::Tensor& pts, const torch::Tensor& digits,
                      int64_t n, torch::Tensor idx, torch::Tensor bstart,
                      torch::Tensor istart, torch::Tensor item_bucket,
                      torch::Tensor partial, torch::Tensor B,
                      torch::Tensor tbuf, torch::Tensor T, torch::Tensor G,
                      torch::Tensor out, int64_t stage) {
  const c10::cuda::CUDAGuard guard(pts.device());
  const int rc = bls381_pippenger_launch(
      pts.data_ptr(), digits.data_ptr(), n, idx.data_ptr(),
      bstart.data_ptr(), istart.data_ptr(), item_bucket.data_ptr(),
      partial.data_ptr(), B.data_ptr(), tbuf.data_ptr(), T.data_ptr(),
      G.data_ptr(), out.data_ptr(), static_cast<int>(stage),
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("sha256_pairs", &sha256_pairs, "SHA-256 of each 64-byte chunk pair");
  m.def("sha256_gather", &sha256_gather,
        "SHA-256 of chunk pairs gathered by index, written in place");
  m.def("epoch_sweep", &epoch_sweep,
        "the per-validator epoch sweep, up to two launches");
  m.def("bls381_field", &bls381_field,
        "a BLS12-381 field, tower or curve op, elementwise");
  m.def("bls381_ladder", &bls381_ladder, "the windowed G2 ladder");
  m.def("bls381_miller", &bls381_miller, "Miller loops, one a pair");
  m.def("bls381_final", &bls381_final,
        "a job's Miller product and final exponentiation");
  m.def("bls381_segment_sum", &bls381_segment_sum,
        "halving sums of point segments, four warps a segment (K1)");
  m.def("bls381_g1_ladder", &bls381_g1_ladder, "the windowed G1 ladder (K2)");
  m.def("bls381_fold_w", &bls381_fold_w,
        "the folded flush's weighting leg, affine");
  m.def("bls381_fold_sw", &bls381_fold_sw,
        "the folded flush's signature leg, Jacobian");
  m.def("bls381_fold_h", &bls381_fold_h,
        "the folded flush's cofactor pairs at infinity");
  m.def("bls381_fold_tail", &bls381_fold_tail,
        "the folded flush's last pair (-G1, S)");
  m.def("bls381_clear_cofactor", &bls381_clear_cofactor,
        "G2 cofactor clearing by psi, affine");
  m.def("bls381_pairing_check", &bls381_pairing_check,
        "pairing checks, four warps a job");
  m.def("bls381_pippenger", &bls381_pippenger,
        "the Pippenger MSM: bucketing, chunk sums, trees and Horner");
}
