// BLS12-381 field, tower and curve operations, elementwise, for Hopper
// (sm_90a): out[i] = op(a[i], b[i]), one thread an element.
//
// Replaces the elementwise XLA programs of consensus_specs_tpu/ops/fq.py
// (`mul`, `add`, `sub`, `neg`), ops/fq_tower.py (`fq2_*`, `fq12_mul`,
// `fq12_square`, `fq12_cyclotomic_square`, `fq12_frobenius`, `fq12_conj`,
// the inverses) and ops/curve_jax.py (`point_add`, `point_double`).  It
// exposes the device functions of bls381.cuh that the ladder and pairing
// kernels are built from, so each one can be held against the plain torch
// version on the card, and it normalizes the cofactor ladder's Jacobian
// outputs to affine (Fq2 inverse, square and products) on the signature
// path.
//
// What bounds it: operations, the CIOS products' 32-bit multiplies (588 a
// product; an Fq12 product is 54 of them, an Fq inverse 380 squarings and
// the multiplies of q - 2's set bits).  One thread an element with the
// element's words in registers and local memory; the op code is a uniform
// branch.
//
// Elements arrive as int32 tensors read as uint32 words: 12 an Fq element
// (Montgomery form), 24 an Fq2, 144 an Fq12, 36 a G1 and 72 a G2 Jacobian
// point (X, Y, Z).

#include "bls381.cuh"

namespace {

__global__ void __launch_bounds__(128)
bls381_field_kernel(int op, const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b,
                    uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t w = field_op_words(op);
  field_op_elem(op, a + i * w, b == nullptr ? nullptr : b + i * w,
                out + i * w);
}

}  // namespace

// Plain C entry: n elements of op's type in a (and b for a binary op; null
// for a unary one), written to out.  Launches on `stream` and returns
// cudaGetLastError() as an int (cudaErrorInvalidValue for an unknown op).
extern "C" int bls381_field_launch(int op, const void* a, const void* b,
                                   void* out, int64_t n, void* stream) {
  constexpr int kThreads = 128;
  if (op < 0 || op >= OP_COUNT) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    bls381_field_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        op, static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<uint32_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
