// SHA-256 of one 64-byte message on Hopper (sm_90a): the body shared by the
// pair-hash kernel (sha256_pairs.cu) and the gather-hash kernel
// (sha256_gather.cu).
//
// It is the body of consensus_specs_tpu/ops/sha256_pallas.py::_sha256_kernel:
// compress the message block from the IV, then compress the constant pad
// block of a 64-byte message.  Design (see sha256_pairs.cu for what bounds
// it):
//   - the caller holds the 16 message words in registers; the 8 state words
//     and a rolling 16-word message schedule stay there, with the round loop
//     fully unrolled so every schedule index is a compile-time register name;
//   - the round constants sit in __constant__ memory, read by every lane of a
//     warp at the same index (a broadcast); the pad block's message schedule
//     does not depend on the input, so its 64 words are folded with the round
//     constants into one constant table (kPadKW) and the second compression
//     does no schedule work at all;
//   - rotates are __funnelshift_r (one SHF each).
//
// Everything is in an anonymous namespace: each kernel file that includes
// this header gets its own copy of the constant tables.

#pragma once

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

// The digest of the 64-byte message `w` (16 host-order words), into `out`.
__device__ __forceinline__ void sha256_64byte(uint32_t (&w)[16],
                                              uint32_t (&out)[8]) {
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

#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = s[k] + mid[k];
}

}  // namespace
