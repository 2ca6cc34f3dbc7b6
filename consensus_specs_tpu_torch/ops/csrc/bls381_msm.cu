// Batched point sums and G1 scalar ladders for Hopper (sm_90a): the
// signature pipeline's committee sums, G2 signature sum and Fiat-Shamir
// weighting.
//
//   segment_sum (K1): one thread block a segment of L points (L a power of
//     two) sums it by halving in place in a device scratch copy: round h =
//     L/2, ..., 1 adds point i + h into point i for i < h, with a barrier
//     between rounds, and the segment's sum is point 0.  Templated on the
//     field: G1 (fp) for committee pubkey sums, G2 (fp2) for the folded
//     signature sum.
//   g1_ladder (K2): one thread a point runs the msb-first double-and-add
//     over its own bit row (the G1 twin of bls381_g2.cu's ladder).
//
// Replaces consensus_specs_tpu/ops/g1_sweep.py `_jax_sweep` (a [segments,
// L] Jacobian tensor reduced by log2(L) batched `point_add` launches at
// halving shapes), the halving sum of ops/msm.py `g2_multi_exp`
// (`_tree_sum_host`) and the ladder of ops/msm.py `g1_weighted_sweep`
// (`cj.g1_scalar_mul` over [n, 64] bits).  The pair order of the halving is
// the reference's and the plain version's, and the point formulas are
// theirs (bls381.cuh pt_add, pt_double), so the Jacobian outputs equal the
// plain version bit for bit.
//
// What bounds them: operations, the CIOS products' 32-bit multiplies (a G1
// add is 16 Fq products, a G2 add 43; a 64-bit G1 ladder about 64 doublings
// of 7 and 32 adds of 16).  A segment sum of L points is L - 1 adds on
// log2(L) rounds, so its depth is log2(L) adds and its first rounds run
// L/2 threads of the block; a ladder is one thread's chain of dependent
// products.  Simple and right first: one block a segment leaves the card
// mostly idle at a phase0 block's 8 committees.
//
// Layouts (int32 tensors read as uint32 words, Montgomery form): a G1
// point (X, Y, Z) is 36 words, a G2 point 72; segment_sum reads and
// overwrites buf [segments, L, point] and writes out [segments, point];
// g1_ladder reads pts [n, 36] and bits uint8 [n, nbits] and writes out
// [n, 36].

#include "bls381.cuh"

namespace {

constexpr int kSegmentThreads = 128;
constexpr int kLadderThreads = 64;

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

__global__ void __launch_bounds__(kLadderThreads)
bls381_g1_ladder_kernel(const uint32_t* __restrict__ pts,
                        const uint8_t* __restrict__ bits, int64_t nbits,
                        uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  g1_ladder_elem(pts + i * 3 * BLS_NW, bits + i * nbits, nbits,
                 out + i * 3 * BLS_NW);
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

// Plain C entry of K2: n G1 points (36 words each) and their bit rows, the
// products written to out.  Launches on `stream` and returns
// cudaGetLastError() as an int.
extern "C" int bls381_g1_ladder_launch(const void* pts, const void* bits,
                                       int64_t nbits, void* out, int64_t n,
                                       void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + kLadderThreads - 1) / kLadderThreads;
    bls381_g1_ladder_kernel<<<static_cast<unsigned int>(blocks),
                              kLadderThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(pts), static_cast<const uint8_t*>(bits),
        nbits, static_cast<uint32_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
