// The windowed Pippenger G1 MSM's device bodies (bls381_pippenger.cu), on
// bls381.cuh's point formulas.
//
// sum_i s_i P_i over n Jacobian G1 points, in the reference's order of
// additions (consensus_specs_tpu/ops/msm.py `_pippenger_g1`, and the port's
// plain version ops/msm.py `_pippenger_g1`), so the Jacobian result equals
// the plain version's bit for bit.  With WB-bit windows (window 0 the most
// significant), kWindows = 256 / WB windows, kBuckets = 2^WB - 1 buckets and
// T bucket-table lanes a window:
//
//   fold (launch 1): lane (w, t) walks its chunk of n / T points,
//     i = t * chunk + j for j = 0, 1, ..., and adds point i into bucket
//     digit[w][i] of its own table (table + point; digit 0 adds nothing);
//   merge (launch 2): log2(T) rounds, h = T/2, ..., 1, add lane t + h into
//     lane t for t < h, bucket by bucket; lane 0 then holds each bucket's
//     sum S_b;
//   scans (launch 2): two suffix scans of ceil(log2(kBuckets)) Hillis-Steele
//     rounds each, P[i] <- P[i] + P[i + 2^r] where i + 2^r < kBuckets, every
//     lane reading the round's old values (two buffers, a barrier between
//     rounds); after both, position 0 holds sum_b (b + 1) S_b, the window's
//     weighted sum G_w;
//   Horner (launch 3): acc = 0; for each window, WB doublings, then
//     acc + G_w.
//
// The scans' out-of-range lanes keep their value: the reference adds a
// masked copy of itself and discards it, the same result.  Merge rounds
// skip the digit-0 dump slot, which the reference merges and never reads.
//
// The window launch runs with any number of threads a block (the host build
// runs it with one): each round's elements are spread over the block's
// threads, with a barrier after each round.
//
// Layouts (uint32 words, Montgomery form, a point 36 words): pts [n, 36],
// digits uint8 [kWindows, n] (n a multiple of T), tables
// [kWindows, T, kBuckets + 1, 36] (slot 0 the dump), scan
// [kWindows, 2, kBuckets, 36], G [kWindows, 36], out [36].
#pragma once

#include "bls381.cuh"

#if defined(__CUDACC__)
#define PIP_BARRIER() __syncthreads()
#else
#define PIP_BARRIER() ((void)0)
#endif

#define PIP_PW (3 * BLS_NW)   // words of a G1 Jacobian point

constexpr int pip_bit_length(int x) {
  return x > 0 ? 1 + pip_bit_length(x >> 1) : 0;
}

template <int WB, int T>
struct pip_shape {
  static constexpr int kWindows = 256 / WB;
  static constexpr int kBuckets = (1 << WB) - 1;
  static constexpr int kSlots = kBuckets + 1;
  static constexpr int kScanRounds = pip_bit_length(kBuckets - 1);
  static_assert(T > 0 && (T & (T - 1)) == 0, "T must be a power of two");
  static_assert(256 % WB == 0 && WB <= 8, "WB must divide 256, digits are "
                                          "bytes");
};

// launch 1, lane (w, t): fill its table with infinity, then fold its chunk
template <int WB, int T>
BLS_FN void pip_fold_lane(const uint32_t* pts, const uint8_t* digits,
                          int64_t n, uint32_t* tables, int w, int t) {
  using S = pip_shape<WB, T>;
  uint32_t* tab = tables + (static_cast<int64_t>(w) * T + t) * S::kSlots
                  * PIP_PW;
  const pt<fp> inf = pt_infinity<fp>();
  for (int b = 0; b < S::kSlots; ++b) bls_store(tab + b * PIP_PW, inf);
  const int64_t chunk = n / T;
  const uint8_t* d = digits + static_cast<int64_t>(w) * n + t * chunk;
  const uint32_t* p = pts + t * chunk * PIP_PW;
  for (int64_t j = 0; j < chunk; ++j) {
    const int b = d[j];
    if (b == 0) continue;
    uint32_t* slot = tab + b * PIP_PW;
    bls_store(slot, pt_add(bls_load<pt<fp>>(slot),
                           bls_load<pt<fp>>(p + j * PIP_PW)));
  }
}

// launch 2, one window: the merge rounds, the two suffix scans and G_w, by
// thread `tid` of `nthreads` (every thread of the block calls it)
template <int WB, int T>
BLS_FN void pip_window(uint32_t* tables, uint32_t* scan, uint32_t* G, int w,
                       int tid, int nthreads) {
  using S = pip_shape<WB, T>;
  uint32_t* tab = tables + static_cast<int64_t>(w) * T * S::kSlots * PIP_PW;
  for (int h = T / 2; h >= 1; h /= 2) {
    for (int e = tid; e < h * S::kBuckets; e += nthreads) {
      const int t = e / S::kBuckets;
      const int b = 1 + e % S::kBuckets;
      uint32_t* a = tab + (t * S::kSlots + b) * PIP_PW;
      const uint32_t* c = a + h * S::kSlots * PIP_PW;
      bls_store(a, pt_add(bls_load<pt<fp>>(a), bls_load<pt<fp>>(c)));
    }
    PIP_BARRIER();
  }
  uint32_t* buf = scan + static_cast<int64_t>(w) * 2 * S::kBuckets * PIP_PW;
  const uint32_t* src = tab + PIP_PW;   // lane 0, bucket 1 on
  for (int r = 0; r < 2 * S::kScanRounds; ++r) {
    const int shift = 1 << (r % S::kScanRounds);
    uint32_t* dst = buf + (r % 2) * S::kBuckets * PIP_PW;
    for (int i = tid; i < S::kBuckets; i += nthreads) {
      pt<fp> v = bls_load<pt<fp>>(src + i * PIP_PW);
      if (i + shift < S::kBuckets)
        v = pt_add(v, bls_load<pt<fp>>(src + (i + shift) * PIP_PW));
      bls_store(dst + i * PIP_PW, v);
    }
    PIP_BARRIER();
    src = dst;
  }
  if (tid == 0) {
    for (int j = 0; j < PIP_PW; ++j) G[w * PIP_PW + j] = src[j];
  }
}

// launch 3: Horner over the windows' sums, window 0 the most significant
template <int WB, int T>
BLS_FN void pip_horner(const uint32_t* G, uint32_t* out) {
  using S = pip_shape<WB, T>;
  pt<fp> acc = pt_infinity<fp>();
  for (int w = 0; w < S::kWindows; ++w) {
    for (int i = 0; i < WB; ++i) acc = pt_double(acc);
    acc = pt_add(acc, bls_load<pt<fp>>(G + w * PIP_PW));
  }
  bls_store(out, acc);
}
