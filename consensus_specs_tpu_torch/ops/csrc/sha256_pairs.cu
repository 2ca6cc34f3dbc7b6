// SHA-256 2-to-1 pair hash for Hopper (sm_90a): uint32[2N, 8] -> uint32[N, 8].
//
// Replaces consensus_specs_tpu/ops/sha256_pallas.py::_sha256_kernel (the
// Pallas kernel that every large merkle level and populated subtree of the
// JAX package rides).  It computes the same function: for each pair of
// 32-byte chunks (16 big-endian words), compress the message block from the
// IV, then compress the constant pad block of a 64-byte message.  It does not
// carry over the TPU tiling: there is no tile, no grid of 256-row blocks and
// no padding of the pair count.
//
// What bounds it: integer work, not bytes.  Each pair moves 96 bytes (64 in,
// 32 out) and costs two compressions of 64 rounds: about 3,900 32-bit
// operations of the FIPS 180-4 formulas, at least 2,288 instructions with
// Hopper's three-input LOP3 and IADD3 and the SHF rotate.  So the SMs' issue
// rate (128 lanes an SM a clock) is the limit long before the memory rate;
// the 608 logic ops among them, which only the integer pipe runs (64
// lanes), ask less.  As compiled, the SASS (cuobjdump, counted by
// chip_smoke.py `sass_pipes`) is 2,400 instructions a pair, 2,042 of them
// on the integer pipe and 250 IMAD on the FMA pipe, so the integer pipe
// holds it: at 2^20 pairs the kernel takes about 93% of that pipe's time
// and about twice the issue bound (NVIDIA H100 80GB HBM3, 700 W).  Moving
// adds and shifts onto their IMAD forms is the way under it.  The design
// spends nothing on data movement beyond the one read and one write:
//   - one thread per pair, the two compressions in registers
//     (sha256_core.cuh, shared with the gather-hash kernel);
//   - each thread loads its 64-byte block as four 16-byte loads and stores its
//     digest as two; the ragged edge is a bounds check.
//
// Words arrive as host-order uint32 values (the caller converts the chunks'
// big-endian bytes on the host), inside an int32 tensor.

#include "sha256_core.cuh"

namespace {

__global__ void __launch_bounds__(256)
sha256_pairs_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                    int64_t n_pairs) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_pairs) return;

  uint32_t w[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = in[4 * i + q];
    w[4 * q + 0] = v.x; w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
  }
  uint32_t d[8];
  sha256_64byte(w, d);
  out[2 * i + 0] = make_uint4(d[0], d[1], d[2], d[3]);
  out[2 * i + 1] = make_uint4(d[4], d[5], d[6], d[7]);
}

}  // namespace

// Plain C entry: `in` holds 2 * n_pairs rows of 8 words (16-byte aligned),
// `out` n_pairs rows.  Launches on `stream` and returns cudaGetLastError()
// as an int, so a refused launch is reported to the caller.
extern "C" int sha256_pairs_launch(const void* in, void* out, int64_t n_pairs,
                                   void* stream) {
  constexpr int kThreads = 256;
  if (n_pairs > 0) {
    const int64_t blocks = (n_pairs + kThreads - 1) / kThreads;
    sha256_pairs_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(in), static_cast<uint4*>(out), n_pairs);
  }
  return static_cast<int>(cudaGetLastError());
}
