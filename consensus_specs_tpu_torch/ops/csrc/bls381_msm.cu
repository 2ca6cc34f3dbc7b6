// The G1 scalar ladder for Hopper (sm_90a), K2: the signature pipeline's
// Fiat-Shamir weighting and the lanes of the KZG engine's small MSMs.  K1,
// the segment sums that this file held until the four-warp redesign, runs
// on the check kernel's levels (bls381_segment.cuh, kernel in
// bls381_check.cu).
//
//   g1_ladder (K2): the windowed ladder of bls381_ladder.cuh, a row's
//     table built by LADDER_LANES lanes, then one lane's chain of signed
//     windows; rows split by GLV (s0 over P, s1 over phi(P)) run two
//     chains and one add joins them.  bls381_g2.cu runs the same body over
//     Fq2.
//
// Replaces the ladders of consensus_specs_tpu/ops/msm.py:271
// `g1_weighted_sweep` and :237 `g1_multi_exp`'s lanes (`cj.g1_scalar_mul`
// over [n, 64] or [n, 256] bits).  The ladder's steps are its plain
// version's (ops/curve_torch.py windowed_ladder, glv_ladder); the point
// formulas are the reference's (bls381.cuh pt_add, pt_double), so the
// Jacobian outputs equal the plain versions bit for bit.
//
// What bounds it: not the multiplies (a G1 add is 16 Fq products) but
// each chain of dependent products, about 2 us a product in one warp.  A
// ladder's chain is bls381_ladder.cuh's: 699 products for a 64-bit row,
// 1,380 for a split 256-bit row, where the bit-by-bit ladder paid a
// doubling and, across a warp's rows, an add nearly every bit (1,456 and
// 5,872).
//
// Layouts (int32 tensors read as uint32 words, Montgomery form): a G1
// point (X, Y, Z) is 36 words; g1_ladder reads pts [n, 36] and bits uint8
// [n, nbits] (split: [n, 2, LADDER_SPLIT_BITS], s0's bits then s1's) and
// writes out [n, 36].

#include "bls381_ladder.cuh"

namespace {

constexpr int kLadderThreads = LADDER_ROWS * LADDER_LANES;

// LADDER_ROWS rows a block, LADDER_LANES threads a row
template <bool SPLIT>
__global__ void __launch_bounds__(kLadderThreads)
bls381_g1_ladder_kernel(const uint32_t* __restrict__ pts,
                        const uint8_t* __restrict__ bits, int64_t nbits,
                        uint32_t* __restrict__ out, int64_t n) {
  __shared__ pt<fp> tab[LADDER_ROWS]
                       [SPLIT ? LADDER_SPLIT_ENTRIES : LADDER_ENTRIES];
  const int r = static_cast<int>(threadIdx.x) / LADDER_LANES;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * LADDER_ROWS + r;
  const bool live = row < n;
  const int64_t i = live ? row : 0;
  ladder_row<fp, SPLIT>(tab[r], pts + i * 3 * BLS_NW,
                        bits + i * (SPLIT ? 2 : 1) * nbits, nbits,
                        out + i * 3 * BLS_NW, live);
}

}  // namespace

// Plain C entry of K2: n G1 points (36 words each) and their bit rows
// (split nonzero: [n, 2, nbits] halves, nbits = LADDER_SPLIT_BITS), the
// products written to out.  Launches on `stream` and returns
// cudaGetLastError() as an int (cudaErrorInvalidValue for split rows of
// another width).
extern "C" int bls381_g1_ladder_launch(const void* pts, const void* bits,
                                       int64_t nbits, void* out, int64_t n,
                                       int split, void* stream) {
  if (split && nbits != LADDER_SPLIT_BITS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const unsigned int blocks =
        static_cast<unsigned int>((n + LADDER_ROWS - 1) / LADDER_ROWS);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t* p = static_cast<const uint32_t*>(pts);
    const uint8_t* b = static_cast<const uint8_t*>(bits);
    uint32_t* o = static_cast<uint32_t*>(out);
    if (split) {
      bls381_g1_ladder_kernel<true><<<blocks, kLadderThreads, 0, s>>>(
          p, b, nbits, o, n);
    } else {
      bls381_g1_ladder_kernel<false><<<blocks, kLadderThreads, 0, s>>>(
          p, b, nbits, o, n);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
