// The G2 scalar ladder for Hopper (sm_90a): msb-first double-and-add of
// each Jacobian point over its own bit row, one thread a point.
//
// Replaces consensus_specs_tpu/ops/curve_jax.py `g2_scalar_mul`
// (`point_scalar_mul` over `point_double` and `point_add`), the device half
// of ops/bls_tpu.py `hash_to_g2_batch`: clearing the cofactor of hashed
// points with the 636-bit h_eff (the bits are an input, so shorter ladders
// reuse the kernel).  The output is the reference's Jacobian (X, Y, Z) bit
// for bit: dbl-2009-l and add-2007-bl with its select semantics
// (bls381.cuh pt_double, pt_add).
//
// What bounds it: operations.  A 636-bit h_eff ladder is 636 doublings and
// an add a set bit: about 23,000 Fq products of 588 32-bit multiplies each
// (the exact count of a run comes from the plain version's counter).  One
// thread a point keeps the point and the accumulator (144 words) in
// registers and local memory; the zero bits skip the add with a branch,
// which is uniform across a warp when every row walks the same bits.
//
// Points arrive as int32 [n, 3, 2, 12] words (X, Y, Z in Fq2, Montgomery
// form), bits as uint8 [n, nbits].

#include "bls381.cuh"

namespace {

__global__ void __launch_bounds__(64)
bls381_g2_ladder_kernel(const uint32_t* __restrict__ pts,
                        const uint8_t* __restrict__ bits, int64_t nbits,
                        uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  g2_ladder_elem(pts + i * 6 * BLS_NW, bits + i * nbits, nbits,
                 out + i * 6 * BLS_NW);
}

}  // namespace

// Plain C entry: n points (72 words each) and their bit rows, the products
// written to out.  Launches on `stream` and returns cudaGetLastError() as
// an int.
extern "C" int bls381_g2_ladder_launch(const void* pts, const void* bits,
                                       int64_t nbits, void* out, int64_t n,
                                       void* stream) {
  constexpr int kThreads = 64;
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    bls381_g2_ladder_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(pts), static_cast<const uint8_t*>(bits),
        nbits, static_cast<uint32_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
