// The folded signature flush's lanes for Hopper (sm_90a): everything of a
// flush's one-launch fold before the Miller loops.
//
//   launch 1, fold_lanes: one thread a set i < k runs three ladders,
//     w_i = c_i agg_i (G1, the 64-bit Fiat-Shamir coefficient), H_i =
//     h_eff Q_i (G2, the 636-bit cofactor ladder of hash-to-G2, over
//     exactly the bits ops/bls_cuda.py `hash_to_g2_batch` walks) and sw_i =
//     c_i sig_i (G2, 64 bits); it writes w_i and H_i affine as the set's
//     Miller pair, skipped when either is infinity (the generators stand
//     in), and sw_i Jacobian;
//   then bls381_msm.cu's segment_sum<fp2> sums sw into S (one segment);
//   launch 3, fold_tail: one thread writes the last pair (-G1, affine S),
//     skipped when S is infinity.
//
// The k + 1 pairs then go through bls381_pairing.cu's Miller launch and
// its product launch without the final exponentiation: the flush's
// partial Fq12 product, whose final exponentiation decides the flush.
//
// Replaces consensus_specs_tpu/ops/pairing_jax.py `fold_partial_products`
// (`_fold_partial_fused` over `_fold_partial_core`, `_g1_jacobian_to_affine`,
// `_g2_jacobian_to_affine` and `_fold_assemble`), which the JAX package
// compiles into one XLA program because every dispatch costs a host round
// trip on the TPU.  A launch here costs microseconds, so the flush is five
// launches, each kernel simple.  The Miller inputs depend only on the
// affine points, which are canonical, so the partial product equals the
// plain version's bit for bit whatever order the sum adds in.
//
// What bounds it: operations, the CIOS products' 32-bit multiplies.  A
// lane's cofactor ladder is about 23,900 Fq products, its two 64-bit
// ladders about 1,000 (G1) and 2,400 (G2), its two affine conversions two
// Fermat inverses of about 380 products each; one thread a lane runs them
// as one chain of dependent products, with the three ladders' state in
// registers and local memory.
//
// Layouts (int32 tensors read as uint32 words, Montgomery form): agg
// [k, 36], cbits uint8 [k, ncbits], hq and sig [k, 72], hbits uint8 [nh],
// consts [96] (bls381.cuh FoldConst); outputs g1 [k + 1, 24] (xp, yp),
// g2 [k + 1, 48] (xq, yq), skip uint8 [k + 1] and sw [k, 72].

#include "bls381.cuh"

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
bls381_fold_lanes_kernel(const uint32_t* __restrict__ agg,
                         const uint8_t* __restrict__ cbits, int64_t ncbits,
                         const uint32_t* __restrict__ hq,
                         const uint32_t* __restrict__ sig,
                         const uint8_t* __restrict__ hbits, int64_t nh,
                         const uint32_t* __restrict__ consts,
                         uint32_t* __restrict__ g1, uint32_t* __restrict__ g2,
                         uint8_t* __restrict__ skip,
                         uint32_t* __restrict__ sw, int64_t k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= k) return;
  fold_lane_elem(agg + i * 3 * BLS_NW, cbits + i * ncbits, ncbits,
                 hq + i * 6 * BLS_NW, sig + i * 6 * BLS_NW, hbits, nh, consts,
                 g1 + i * 2 * BLS_NW, g2 + i * 4 * BLS_NW, skip + i,
                 sw + i * 6 * BLS_NW);
}

__global__ void bls381_fold_tail_kernel(const uint32_t* __restrict__ S,
                                        const uint32_t* __restrict__ consts,
                                        uint32_t* __restrict__ g1,
                                        uint32_t* __restrict__ g2,
                                        uint8_t* __restrict__ skip) {
  fold_tail_elem(S, consts, g1, g2, skip);
}

}  // namespace

// Plain C entry of launch 1: k lanes.  Launches on `stream` and returns
// cudaGetLastError() as an int.
extern "C" int bls381_fold_lanes_launch(const void* agg, const void* cbits,
                                        int64_t ncbits, const void* hq,
                                        const void* sig, const void* hbits,
                                        int64_t nh, const void* consts,
                                        void* g1, void* g2, void* skip,
                                        void* sw, int64_t k, void* stream) {
  if (k > 0) {
    const int64_t blocks = (k + kThreads - 1) / kThreads;
    bls381_fold_lanes_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(agg), static_cast<const uint8_t*>(cbits),
        ncbits, static_cast<const uint32_t*>(hq),
        static_cast<const uint32_t*>(sig), static_cast<const uint8_t*>(hbits),
        nh, static_cast<const uint32_t*>(consts), static_cast<uint32_t*>(g1),
        static_cast<uint32_t*>(g2), static_cast<uint8_t*>(skip),
        static_cast<uint32_t*>(sw), k);
  }
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry of launch 3: the pair at index k from the sum S (72
// words).  Launches on `stream` and returns cudaGetLastError() as an int.
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
