// G2 cofactor clearing for Hopper (sm_90a) by the psi endomorphism, with
// the affine result in the same launch: one thread a point.
//
// Replaces the device half of consensus_specs_tpu/ops/bls_tpu.py
// `hash_to_g2_batch`: ops/curve_jax.py `g2_scalar_mul` (`point_scalar_mul`
// over the 636 bits of h_eff), whose oracle is
// consensus_specs_tpu/crypto/hash_to_curve.py `clear_cofactor` (h_eff P),
// and the affine normalization the port ran after it (four launches of
// bls381_field.cu).  The function is the same, h_eff P made affine: the
// Budroni-Pintore method of RFC 9380 G.3 computes it as [x^2 - x - 1] P +
// [x - 1] psi(P) + psi^2(2P), two multiplications by the 64-bit BLS
// parameter x (63 doublings and 5 adds each), psi, psi^2 and seven adds:
// about 2,700 Fq products where the ladder took 23,232, plus one Fq2
// inverse (5 products and a binary GCD) and 11 products for the affine
// words.  Those are canonical, so they equal the ladder's followed by the
// normalization bit for bit.
//
// What bounds it: operations, the CIOS products' 32-bit multiplies, all in
// one thread's dependent chain (a check clears one point).  The products
// are bls381_reg.cuh's register-resident ones; the thread's five points
// (1,440 bytes) live on its stack.  psi's constants c_x = (1 + u)^-((q-1)/3)
// and c_y = (1 + u)^-((q-1)/2) come from the host (curve_torch.psi_consts).
//
// Layouts (int32 tensors read as uint32 words, Montgomery form): pts
// [n, 3, 2, 12] Jacobian, consts [2, 2, 12] (c_x, c_y); writes xy
// [n, 2, 2, 12] (x, y; zeros at infinity) and inf uint8 [n].

#include "bls381_reg.cuh"

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
bls381_cofactor_kernel(const uint32_t* __restrict__ pts,
                       const uint32_t* __restrict__ consts,
                       uint32_t* __restrict__ xy, uint8_t* __restrict__ inf,
                       int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  cofactor_elem(pts + i * RG2_W, consts, xy + i * 2 * RQ2_W, inf + i);
}

}  // namespace

// Plain C entry: n points; launches on `stream` and returns
// cudaGetLastError() as an int.
extern "C" int bls381_clear_cofactor_launch(const void* pts,
                                            const void* consts, void* xy,
                                            void* inf, int64_t n,
                                            void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    bls381_cofactor_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(pts),
        static_cast<const uint32_t*>(consts), static_cast<uint32_t*>(xy),
        static_cast<uint8_t*>(inf), n);
  }
  return static_cast<int>(cudaGetLastError());
}
