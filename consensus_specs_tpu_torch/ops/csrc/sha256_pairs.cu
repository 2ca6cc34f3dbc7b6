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
// rate is the limit long before the memory rate.  The design spends nothing
// on data movement beyond the one read and one write:
//   - one thread per pair; the 8 state words and a rolling 16-word message
//     schedule live in registers, with the round loop fully unrolled so every
//     schedule index is a compile-time register name;
//   - the round constants sit in __constant__ memory, read by every lane of a
//     warp at the same index (a broadcast); the pad block's message schedule
//     does not depend on the input, so its 64 words are folded with the round
//     constants into one constant table (kPadKW) and the second compression
//     does no schedule work at all;
//   - rotates are __funnelshift_r (one SHF each);
//   - each thread loads its 64-byte block as four 16-byte loads and stores its
//     digest as two; the ragged edge is a bounds check.
//
// Words arrive as host-order uint32 values (the caller converts the chunks'
// big-endian bytes on the host), inside an int32 tensor.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ uint32_t kK[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u,
    0x3956c25bu, 0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u,
    0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u,
    0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u,
    0xc6e00bf3u, 0xd5a79147u, 0x06ca6351u, 0x14292967u,
    0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u,
    0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u,
    0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu, 0x682e6ff3u,
    0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};

// kK[t] + W[t] of the pad block (0x80000000, 0 x 14, 512), mod 2^32.
__constant__ uint32_t kPadKW[64] = {
    0xc28a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u,
    0x3956c25bu, 0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u,
    0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf374u,
    0x649b69c1u, 0xf0fe4786u, 0x0fe1edc6u, 0x240cf254u,
    0x4fe9346fu, 0x6cc984beu, 0x61b9411eu, 0x16f988fau,
    0xf2c65152u, 0xa88e5a6du, 0xb019fc65u, 0xb9d99ec7u,
    0x9a1231c3u, 0xe70eeaa0u, 0xfdb1232bu, 0xc7353eb0u,
    0x3069bad5u, 0xcb976d5fu, 0x5a0f118fu, 0xdc1eeefdu,
    0x0a35b689u, 0xde0b7a04u, 0x58f4ca9du, 0xe15d5b16u,
    0x007f3e86u, 0x37088980u, 0xa507ea32u, 0x6fab9537u,
    0x17406110u, 0x0d8cd6f1u, 0xcdaa3b6du, 0xc0bbbe37u,
    0x83613bdau, 0xdb48a363u, 0x0b02e931u, 0x6fd15ca7u,
    0x521afacau, 0x31338431u, 0x6ed41a95u, 0x6d437890u,
    0xc39c91f2u, 0x9eccabbdu, 0xb5c9a0e6u, 0x532fb63cu,
    0xd2c741c6u, 0x07237ea3u, 0xa4954b68u, 0x4c191d76u,
};

__constant__ uint32_t kIV[8] = {
    0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
    0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ uint32_t big_sigma0(uint32_t a) {
  return rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
}

__device__ __forceinline__ uint32_t big_sigma1(uint32_t e) {
  return rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
}

__device__ __forceinline__ uint32_t small_sigma0(uint32_t w) {
  return rotr(w, 7) ^ rotr(w, 18) ^ (w >> 3);
}

__device__ __forceinline__ uint32_t small_sigma1(uint32_t w) {
  return rotr(w, 17) ^ rotr(w, 19) ^ (w >> 10);
}

// One round; `kw` is K[t] + W[t].  The caller rotates the names.
__device__ __forceinline__ void round_step(uint32_t (&s)[8], uint32_t kw) {
  const uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
  const uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
  const uint32_t t1 = h + big_sigma1(e) + ((e & f) ^ (~e & g)) + kw;
  const uint32_t t2 = big_sigma0(a) + ((a & b) ^ (a & c) ^ (b & c));
  s[7] = g; s[6] = f; s[5] = e; s[4] = d + t1;
  s[3] = c; s[2] = b; s[1] = a; s[0] = t1 + t2;
}

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

  // block 1: the 64-byte message, from the IV
  uint32_t s[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = kIV[k];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) {
      w[t & 15] += small_sigma0(w[(t - 15) & 15]) + w[(t - 7) & 15]
                   + small_sigma1(w[(t - 2) & 15]);
    }
    round_step(s, kK[t] + w[t & 15]);
  }
  uint32_t mid[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) { mid[k] = s[k] + kIV[k]; s[k] = mid[k]; }

  // block 2: the constant pad block, schedule folded into kPadKW
#pragma unroll
  for (int t = 0; t < 64; ++t) round_step(s, kPadKW[t]);

  out[2 * i + 0] = make_uint4(s[0] + mid[0], s[1] + mid[1],
                              s[2] + mid[2], s[3] + mid[3]);
  out[2 * i + 1] = make_uint4(s[4] + mid[4], s[5] + mid[5],
                              s[6] + mid[6], s[7] + mid[7]);
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
