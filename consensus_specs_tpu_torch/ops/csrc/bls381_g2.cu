// The G2 scalar ladder for Hopper (sm_90a): bls381_ladder.cuh's windowed
// body over Fq2, a row's table of odd multiples built by LADDER_LANES
// lanes, then one lane's chain of signed windows (no GLV split: G2 rows
// are 64-bit weights or h_eff rows on points outside G2).
//
// Replaces consensus_specs_tpu/ops/curve_jax.py `g2_scalar_mul`
// (`point_scalar_mul` over `point_double` and `point_add`): ops/msm.py:324
// `g2_multi_exp`'s ladder over 64-bit Fiat-Shamir weights (the staged
// flush's signature fold) and the device half of ops/bls_tpu.py
// `hash_to_g2_batch`, clearing the cofactor of hashed points with the
// 636-bit h_eff (the bits are an input).  The output equals its plain
// version (ops/curve_torch.py windowed_ladder) bit for bit: the same
// steps, dbl-2009-l and add-2007-bl with the reference's select semantics
// (bls381.cuh pt_double, pt_add).
//
// What bounds it: each row's chain of dependent Fq products (a doubling
// 16, an add 43), about 2 us a product in one warp, not the card's
// multiply rate.  A 64-bit row is 1,707 dependent products (the
// bit-by-bit ladder: 64 doublings and, across a warp's rows, an add
// nearly every bit, about 3,730); an h_eff row 15,852 (23,248).
//
// Points arrive as int32 [n, 3, 2, 12] words (X, Y, Z in Fq2, Montgomery
// form), bits as uint8 [n, nbits].

#include "bls381_ladder.cuh"

namespace {

constexpr int kThreads = LADDER_ROWS * LADDER_LANES;

// LADDER_ROWS rows a block, LADDER_LANES threads a row
__global__ void __launch_bounds__(kThreads)
bls381_g2_ladder_kernel(const uint32_t* __restrict__ pts,
                        const uint8_t* __restrict__ bits, int64_t nbits,
                        uint32_t* __restrict__ out, int64_t n) {
  __shared__ pt<fp2> tab[LADDER_ROWS][LADDER_ENTRIES];
  const int r = static_cast<int>(threadIdx.x) / LADDER_LANES;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * LADDER_ROWS + r;
  const bool live = row < n;
  const int64_t i = live ? row : 0;
  ladder_row<fp2, false>(tab[r], pts + i * 6 * BLS_NW, bits + i * nbits,
                         nbits, out + i * 6 * BLS_NW, live);
}

}  // namespace

// Plain C entry: n points (72 words each) and their bit rows, the products
// written to out.  Launches on `stream` and returns cudaGetLastError() as
// an int.
extern "C" int bls381_g2_ladder_launch(const void* pts, const void* bits,
                                       int64_t nbits, void* out, int64_t n,
                                       void* stream) {
  if (n > 0) {
    const unsigned int blocks =
        static_cast<unsigned int>((n + LADDER_ROWS - 1) / LADDER_ROWS);
    bls381_g2_ladder_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(pts), static_cast<const uint8_t*>(bits),
        nbits, static_cast<uint32_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
