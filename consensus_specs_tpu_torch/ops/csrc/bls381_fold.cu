// The folded signature flush's lanes for Hopper (sm_90a): everything of a
// flush's one-launch fold before the Miller loops, a leg a kernel, the
// legs on three streams (ops/bls381_cuda.py `fold_lanes` forks and joins
// them):
//
//   cofactor stream: bls381_cofactor.cu's kernel on the k hash points
//     (H_i = h_eff Q_i by the psi method, affine, into the pairs' G2
//     words), then fold_h (the G2 generator where H_i is infinity, and
//     skip);
//   weighting stream: fold_w, w_i = c_i agg_i (G1, the 64-bit Fiat-Shamir
//     coefficient), affine into the pairs' G1 words (the G1 generator and
//     skip where w_i is infinity);
//   the caller's stream: fold_sw, sw_i = c_i sig_i (G2, 64 bits,
//     Jacobian), then K1 (bls381_check.cu) over G2 sums sw into S (one
//     segment), then fold_tail: one thread writes the last pair (-G1,
//     affine S), skipped when S is infinity.
//
// The k + 1 pairs then go through the pairing's Miller launch and
// its product launch without the final exponentiation: the flush's
// partial Fq12 product, whose final exponentiation decides the flush.
//
// Replaces consensus_specs_tpu/ops/pairing_jax.py `fold_partial_products`
// (`_fold_partial_fused` over `_fold_partial_core`, `_g1_jacobian_to_affine`,
// `_g2_jacobian_to_affine` and `_fold_assemble`), which the JAX package
// compiles into one XLA program because every dispatch costs a host round
// trip on the TPU.  A launch here costs microseconds, so the flush is a
// few launches, each kernel simple.  The Miller inputs depend only on the
// affine points, which are canonical, so the partial product equals the
// plain version's bit for bit whatever order the sum adds in.
//
// What bounds it: operations, the CIOS products' 32-bit multiplies, each a
// dependent chain in one thread (about 2-3 us a product on the card,
// whatever its form).  So the design shortens each thread's chain and
// runs the chains side by side: a set's legs are three kernels on three
// streams, and the fold's time is its longest leg, not the sum of the
// three.  The cofactor leg is the psi method's 2,711 products where the
// 636-bit ladder over h_eff's bits took about 23,200; the 64-bit G2 ladder
// is about 2,400, the G1 ladder about 1,000, with a Fermat inverse of about
// 380 for the affine words.  Each leg is a __global__ of its own, so ptxas
// allocates each for its own leg, not for the union of the three.  No
// tensor-core (wgmma) or TMA form fits: a product is a chain of dependent
// 381-bit multiply-adds with carries over a few hundred bytes of state,
// not a tile, and there is nothing to stream.
//
// Layouts (int32 tensors read as uint32 words, Montgomery form): agg
// [k, 36], cbits uint8 [k, ncbits], sig [k, 72], consts [96] (bls381.cuh
// FoldConst), h_inf uint8 [k] (the cofactor kernel's flags); outputs g1
// [k + 1, 24] (xp, yp), g2 [k + 1, 48] (xq, yq; rows below k from the
// cofactor kernel), skip uint8 [k + 1] (zero before the legs) and sw
// [k, 72].

#include "bls381_fold.cuh"

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
bls381_fold_w_kernel(const uint32_t* __restrict__ agg,
                     const uint8_t* __restrict__ cbits, int64_t ncbits,
                     const uint32_t* __restrict__ consts,
                     uint32_t* __restrict__ g1, uint8_t* __restrict__ skip,
                     int64_t k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= k) return;
  fold_w_elem(agg + i * 3 * BLS_NW, cbits + i * ncbits, ncbits, consts,
              g1 + i * 2 * BLS_NW, skip + i);
}

__global__ void __launch_bounds__(kThreads)
bls381_fold_sw_kernel(const uint32_t* __restrict__ sig,
                      const uint8_t* __restrict__ cbits, int64_t ncbits,
                      uint32_t* __restrict__ sw, int64_t k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= k) return;
  fold_sw_elem(sig + i * 6 * BLS_NW, cbits + i * ncbits, ncbits,
               sw + i * 6 * BLS_NW);
}

__global__ void __launch_bounds__(kThreads)
bls381_fold_h_kernel(const uint8_t* __restrict__ h_inf,
                     const uint32_t* __restrict__ consts,
                     uint32_t* __restrict__ g2, uint8_t* __restrict__ skip,
                     int64_t k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= k) return;
  fold_h_elem(h_inf[i], consts, g2 + i * 4 * BLS_NW, skip + i);
}

__global__ void bls381_fold_tail_kernel(const uint32_t* __restrict__ S,
                                        const uint32_t* __restrict__ consts,
                                        uint32_t* __restrict__ g1,
                                        uint32_t* __restrict__ g2,
                                        uint8_t* __restrict__ skip) {
  fold_tail_elem(S, consts, g1, g2, skip);
}

unsigned int blocks(int64_t k) {
  return static_cast<unsigned int>((k + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entries, one a kernel: each launches on `stream` and returns
// cudaGetLastError() as an int.

// the weighting leg of k sets; skip must be zero before the legs
extern "C" int bls381_fold_w_launch(const void* agg, const void* cbits,
                                    int64_t ncbits, const void* consts,
                                    void* g1, void* skip, int64_t k,
                                    void* stream) {
  if (k > 0)
    bls381_fold_w_kernel<<<blocks(k), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(agg), static_cast<const uint8_t*>(cbits),
        ncbits, static_cast<const uint32_t*>(consts),
        static_cast<uint32_t*>(g1), static_cast<uint8_t*>(skip), k);
  return static_cast<int>(cudaGetLastError());
}

// the signature leg of k sets
extern "C" int bls381_fold_sw_launch(const void* sig, const void* cbits,
                                     int64_t ncbits, void* sw, int64_t k,
                                     void* stream) {
  if (k > 0)
    bls381_fold_sw_kernel<<<blocks(k), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(sig), static_cast<const uint8_t*>(cbits),
        ncbits, static_cast<uint32_t*>(sw), k);
  return static_cast<int>(cudaGetLastError());
}

// the cofactor leg's pairs after bls381_cofactor.cu wrote g2's first k
// rows and h_inf; skip must be zero before the legs
extern "C" int bls381_fold_h_launch(const void* h_inf, const void* consts,
                                    void* g2, void* skip, int64_t k,
                                    void* stream) {
  if (k > 0)
    bls381_fold_h_kernel<<<blocks(k), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(h_inf),
        static_cast<const uint32_t*>(consts), static_cast<uint32_t*>(g2),
        static_cast<uint8_t*>(skip), k);
  return static_cast<int>(cudaGetLastError());
}

// the pair at index k from the sum S (72 words)
extern "C" int bls381_fold_tail_launch(const void* S, const void* consts,
                                       void* g1, void* g2, void* skip,
                                       int64_t k, void* stream) {
  bls381_fold_tail_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(S), static_cast<const uint32_t*>(consts),
      static_cast<uint32_t*>(g1) + k * 2 * BLS_NW,
      static_cast<uint32_t*>(g2) + k * 4 * BLS_NW,
      static_cast<uint8_t*>(skip) + k);
  return static_cast<int>(cudaGetLastError());
}
