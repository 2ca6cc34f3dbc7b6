// Batched point sums and G1 scalar ladders for Hopper (sm_90a): the
// signature pipeline's committee sums, G2 signature sum and Fiat-Shamir
// weighting, and the lanes of the KZG engine's small MSMs.
//
//   segment_sum (K1): one thread block a segment of L points (L a power of
//     two) sums it by halving in place in a device scratch copy: round h =
//     L/2, ..., 1 adds point i + h into point i for i < h, with a barrier
//     between rounds, and the segment's sum is point 0.  Templated on the
//     field: G1 (fp) for committee pubkey sums, G2 (fp2) for the folded
//     signature sum.
//   g1_ladder (K2): the windowed ladder of bls381_ladder.cuh, a row's
//     table built by LADDER_LANES lanes, then one lane's chain of signed
//     windows; rows split by GLV (s0 over P, s1 over phi(P)) run two
//     chains and one add joins them.  bls381_g2.cu runs the same body over
//     Fq2.
//
// Replaces consensus_specs_tpu/ops/g1_sweep.py `_jax_sweep` (a [segments,
// L] Jacobian tensor reduced by log2(L) batched `point_add` launches at
// halving shapes), the halving sum of ops/msm.py `g2_multi_exp`
// (`_tree_sum_host`), and the ladders of ops/msm.py:271
// `g1_weighted_sweep` and :237 `g1_multi_exp`'s lanes (`cj.g1_scalar_mul`
// over [n, 64] or [n, 256] bits).  The pair order of the halving is the
// reference's and the plain version's; the ladder's steps are its plain
// version's (ops/curve_torch.py windowed_ladder, glv_ladder); the point
// formulas are the reference's (bls381.cuh pt_add, pt_double), so the
// Jacobian outputs equal the plain versions bit for bit.
//
// What bounds them: not the multiplies (a G1 add is 16 Fq products) but
// each chain of dependent products, about 2 us a product in one warp.  A
// segment sum of L points is L - 1 adds on log2(L) rounds, so its depth is
// log2(L) adds and its first rounds run L/2 threads of the block.  A
// ladder's chain is bls381_ladder.cuh's: 699 products for a 64-bit row,
// 1,380 for a split 256-bit row, where the bit-by-bit ladder paid a
// doubling and, across a warp's rows, an add nearly every bit (1,456 and
// 5,872).
//
// Layouts (int32 tensors read as uint32 words, Montgomery form): a G1
// point (X, Y, Z) is 36 words, a G2 point 72; segment_sum reads and
// overwrites buf [segments, L, point] and writes out [segments, point];
// g1_ladder reads pts [n, 36] and bits uint8 [n, nbits] (split: [n, 2,
// LADDER_SPLIT_BITS], s0's bits then s1's) and writes out [n, 36].

#include "bls381_ladder.cuh"

namespace {

constexpr int kSegmentThreads = 128;
constexpr int kLadderThreads = LADDER_ROWS * LADDER_LANES;

template <typename F>
__global__ void __launch_bounds__(kSegmentThreads)
bls381_segment_sum_kernel(uint32_t* buf, int64_t len,
                          uint32_t* __restrict__ out) {
  const int64_t w = sizeof(pt<F>) / 4;
  uint32_t* seg = buf + static_cast<int64_t>(blockIdx.x) * len * w;
  for (int64_t h = len / 2; h >= 1; h /= 2) {
    for (int64_t i = threadIdx.x; i < h; i += blockDim.x)
      segment_step_elem<F>(seg, i, h);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    for (int64_t j = 0; j < w; ++j)
      out[static_cast<int64_t>(blockIdx.x) * w + j] = seg[j];
  }
}

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

// Plain C entry of K1: `segments` segments of `len` points each (G2 when g2
// is nonzero, else G1), a power of two; buf is overwritten.  Launches on
// `stream` and returns cudaGetLastError() as an int (cudaErrorInvalidValue
// for a length that is not a power of two).
extern "C" int bls381_segment_sum_launch(int g2, void* buf, int64_t len,
                                         void* out, int64_t segments,
                                         void* stream) {
  if (len < 1 || (len & (len - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (segments > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned int blocks = static_cast<unsigned int>(segments);
    if (g2) {
      bls381_segment_sum_kernel<fp2><<<blocks, kSegmentThreads, 0, s>>>(
          static_cast<uint32_t*>(buf), len, static_cast<uint32_t*>(out));
    } else {
      bls381_segment_sum_kernel<fp><<<blocks, kSegmentThreads, 0, s>>>(
          static_cast<uint32_t*>(buf), len, static_cast<uint32_t*>(out));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

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
