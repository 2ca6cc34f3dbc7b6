// The windowed Pippenger G1 MSM's device bodies (bls381_pippenger.cu), on
// bls381.cuh's point formulas.
//
// sum_i s_i P_i over n Jacobian G1 points.  With WB-bit windows (window 0
// the most significant; kWindows = 256 / WB), digit values 0 .. 2^WB - 1
// (bucket b collects the points whose digit is b; digit 0 adds nothing)
// and work items of at most C points:
//
//   bucket (launch 1, a block a window): per bucket b, its count by a
//     scan of the window's digits, an exclusive scan of the counts (bstart,
//     each bucket's slice of idx) and of the items a bucket needs,
//     ceil(count / C) (istart, each bucket's first item), then each
//     bucket's point indices in increasing order (idx) and each item's
//     bucket (item_bucket; 0 marks an item slot past the window's last);
//   sums (launch 2, a thread an item): item q of bucket b sums the points
//     idx[bstart[b] + q C ...] of its chunk, at most C - 1 dependent adds,
//     mixed adds (madd-2007-bl, 11 products) where the point's Z is
//     Montgomery one, as every decoded point's is;
//   tree (launch 3, a block a window): each bucket's item partials summed
//     in place by a tree, round h adding item q + h into item q for q a
//     multiple of 2h, then the bucket sums B_b written densely (infinity
//     where a bucket is empty);
//   bits (launch 4, a block a window and bit): T_j = sum of the B_b whose
//     bucket index b has bit j set, a halving tree over 2^(WB-1) buckets;
//   horner (launch 5, one block): each window's G_w = sum_b b B_b =
//     sum_j 2^j T_j by WB - 1 doublings and adds (a thread a window), then
//     one thread's Horner over the windows, WB doublings and an add each.
//
// So no thread's chain of dependent adds grows with the scalars: C - 1 in
// a chunk, log2(n / C) rounds of a bucket's tree, WB - 1 rounds of a bit
// tree, 2 (WB - 1) to combine a window; whatever digits the scalars give
// (all equal, a window's n points in one bucket), only Horner's 248
// doublings and 31 adds (WB = 8) are one long chain, the design's floor.
//
// Any order of additions gives the same group element, so the result's
// affine coordinates (and compressed bytes) equal the plain version's
// (ops/msm.py `_pippenger_g1`, which adds in the reference's order) and
// the host oracle's (crypto/curve.py `msm`); its Jacobian words are free.
//
// Every body takes its thread's index `tid` of `nthreads` where a launch
// spreads a window over a block, and walks its share of each round with a
// barrier after each round; the host build (no __CUDACC__) runs each with
// one thread.
//
// Layouts (uint32 words, Montgomery form, a point 36 words; m =
// kBuckets + ceil(n / C) item slots a window): pts [n, 36], digits uint8
// [kWindows, n], idx int32 [kWindows, n], bstart and istart int32
// [kWindows, kSlots + 1], item_bucket int32 [kWindows, m], partial
// [kWindows, m, 36], B [kWindows, kSlots, 36], tbuf
// [kWindows, WB, kLeaves / 2, 36], T [kWindows, WB, 36], G [kWindows, 36],
// out [36].
#pragma once

#include "bls381.cuh"

#if defined(__CUDACC__)
#define PIP_BARRIER() __syncthreads()
#define PIP_HD __host__ __device__
#else
#define PIP_BARRIER() ((void)0)
#define PIP_HD
#endif

#define PIP_PW (3 * BLS_NW)   // words of a G1 Jacobian point

template <int WB, int C>
struct pip_shape {
  static constexpr int kWindows = 256 / WB;
  static constexpr int kSlots = 1 << WB;       // digit values, 0 unused
  static constexpr int kBuckets = kSlots - 1;
  static constexpr int kLeaves = kSlots / 2;   // buckets with bit j set
  static_assert(256 % WB == 0 && WB >= 2 && WB <= 8,
                "WB must divide 256, digits are bytes");
  static_assert(C >= 1, "a work item holds at least one point");
  // item slots a window: a bucket of c points needs ceil(c / C) items, and
  // sum_b ceil(c_b / C) <= kBuckets + ceil(n / C)
  static PIP_HD int64_t items(int64_t n) {
    return kBuckets + (n + C - 1) / C;
  }
};

// P1 + P2 for P2 with Z = one (Montgomery), madd-2007-bl: 7 products and
// 4 squares; infinity on the left gives P2, equal inputs double, opposite
// inputs give (1, 1, 0)
BLS_CALL pt<fp> pip_madd(const pt<fp>& p1, const pt<fp>& p2) {
  if (fp_is_zero(p1.z)) return p2;
  const fp Z1Z1 = fp_sqr(p1.z);
  const fp U2 = fp_mul(p2.x, Z1Z1);
  const fp S2 = fp_mul(p2.y, fp_mul(p1.z, Z1Z1));
  const fp H = fp_sub(U2, p1.x);
  fp r = fp_sub(S2, p1.y);
  r = fp_add(r, r);
  if (fp_is_zero(H)) {
    if (fp_is_zero(r)) return pt_double(p1);
    return pt_infinity<fp>();
  }
  const fp HH = fp_sqr(H);
  fp I = fp_add(HH, HH);
  I = fp_add(I, I);
  const fp J = fp_mul(H, I);
  const fp V = fp_mul(p1.x, I);
  pt<fp> o;
  o.x = fp_sub(fp_sub(fp_sqr(r), J), fp_add(V, V));
  const fp YJ = fp_mul(p1.y, J);
  o.y = fp_sub(fp_mul(r, fp_sub(V, o.x)), fp_add(YJ, YJ));
  o.z = fp_sub(fp_sub(fp_sqr(fp_add(p1.z, H)), Z1Z1), HH);
  return o;
}

// acc + p: the mixed add where p's Z is one, else the general add
BLS_FN pt<fp> pip_add_point(const pt<fp>& acc, const uint32_t* p) {
  const pt<fp> q = bls_load<pt<fp>>(p);
  return fp_eq(q.z, fp_one()) ? pip_madd(acc, q) : pt_add(acc, q);
}

// launch 1, window w, by thread tid of nthreads; sh is the block's scratch
// of 2 (kSlots + 1) ints (shared memory on the card)
template <int WB, int C>
BLS_FN void pip_bucket(const uint8_t* digits, int64_t n, int32_t* idx,
                       int32_t* bstart, int32_t* istart,
                       int32_t* item_bucket, int32_t* sh, int w, int tid,
                       int nthreads) {
  using S = pip_shape<WB, C>;
  const uint8_t* d = digits + static_cast<int64_t>(w) * n;
  int32_t* bs = sh;                       // counts, then their scan
  int32_t* is = sh + S::kSlots + 1;
  for (int b = tid; b < S::kSlots; b += nthreads) {
    int32_t c = 0;
    if (b > 0)
      for (int64_t i = 0; i < n; ++i) c += d[i] == b;
    bs[b + 1] = c;
    is[b + 1] = (c + C - 1) / C;
  }
  PIP_BARRIER();
  if (tid == 0) {
    bs[0] = 0;
    is[0] = 0;
    for (int b = 1; b <= S::kSlots; ++b) {
      bs[b] += bs[b - 1];
      is[b] += is[b - 1];
    }
  }
  PIP_BARRIER();
  const int64_t m = S::items(n);
  int32_t* row_b = bstart + static_cast<int64_t>(w) * (S::kSlots + 1);
  int32_t* row_i = istart + static_cast<int64_t>(w) * (S::kSlots + 1);
  for (int b = tid; b <= S::kSlots; b += nthreads) {
    row_b[b] = bs[b];
    row_i[b] = is[b];
  }
  int32_t* ix = idx + static_cast<int64_t>(w) * n;
  int32_t* ib = item_bucket + static_cast<int64_t>(w) * m;
  for (int b = tid; b < S::kSlots; b += nthreads) {
    if (b == 0) continue;
    int32_t pos = bs[b];
    for (int64_t i = 0; i < n; ++i)
      if (d[i] == b) ix[pos++] = static_cast<int32_t>(i);
    for (int32_t j = is[b]; j < is[b + 1]; ++j) ib[j] = b;
  }
  for (int64_t j = is[S::kSlots] + tid; j < m; j += nthreads) ib[j] = 0;
}

// launch 2, item j of window w: its chunk's sum into partial
template <int WB, int C>
BLS_FN void pip_bucket_sum(const uint32_t* pts, int64_t n, const int32_t* idx,
                           const int32_t* bstart, const int32_t* istart,
                           const int32_t* item_bucket, uint32_t* partial,
                           int w, int64_t j) {
  using S = pip_shape<WB, C>;
  const int64_t m = S::items(n);
  const int b = item_bucket[w * m + j];
  if (b == 0) return;
  const int32_t* row_b = bstart + static_cast<int64_t>(w) * (S::kSlots + 1);
  const int32_t* row_i = istart + static_cast<int64_t>(w) * (S::kSlots + 1);
  const int32_t* ix = idx + static_cast<int64_t>(w) * n;
  const int64_t lo = row_b[b] + (j - row_i[b]) * C;
  const int64_t end = row_b[b + 1];
  const int64_t hi = lo + C < end ? lo + C : end;
  pt<fp> acc = bls_load<pt<fp>>(pts + static_cast<int64_t>(ix[lo]) * PIP_PW);
  for (int64_t p = lo + 1; p < hi; ++p)
    acc = pip_add_point(acc, pts + static_cast<int64_t>(ix[p]) * PIP_PW);
  bls_store(partial + (w * m + j) * PIP_PW, acc);
}

// launch 3, window w: each bucket's items summed by a tree in place, then
// the bucket sums into B (infinity for digit 0 and empty buckets)
template <int WB, int C>
BLS_FN void pip_bucket_tree(uint32_t* partial, int64_t n,
                            const int32_t* istart, const int32_t* item_bucket,
                            uint32_t* B, int w, int tid, int nthreads) {
  using S = pip_shape<WB, C>;
  const int64_t m = S::items(n);
  const int32_t* row_i = istart + static_cast<int64_t>(w) * (S::kSlots + 1);
  const int32_t* ib = item_bucket + static_cast<int64_t>(w) * m;
  uint32_t* part = partial + static_cast<int64_t>(w) * m * PIP_PW;
  const int64_t n_items = row_i[S::kSlots];
  const int64_t max_items = (n + C - 1) / C;   // of one bucket
  for (int64_t h = 1; h < max_items; h *= 2) {
    for (int64_t j = tid; j < n_items; j += nthreads) {
      const int b = ib[j];
      const int64_t q = j - row_i[b];
      if (q % (2 * h) == 0 && q + h < row_i[b + 1] - row_i[b]) {
        uint32_t* a = part + j * PIP_PW;
        bls_store(a, pt_add(bls_load<pt<fp>>(a),
                            bls_load<pt<fp>>(a + h * PIP_PW)));
      }
    }
    PIP_BARRIER();
  }
  uint32_t* Bw = B + static_cast<int64_t>(w) * S::kSlots * PIP_PW;
  for (int b = tid; b < S::kSlots; b += nthreads) {
    if (b > 0 && row_i[b + 1] > row_i[b])
      for (int k = 0; k < PIP_PW; ++k)
        Bw[b * PIP_PW + k] = part[static_cast<int64_t>(row_i[b]) * PIP_PW + k];
    else
      bls_store(Bw + b * PIP_PW, pt_infinity<fp>());
  }
}

// launch 4, window w and bit j: T_j = the sum of the buckets with bit j
// set, halving over the kLeaves of them (leaf i is bucket i with a one
// bit inserted at j) through tbuf
template <int WB, int C>
BLS_FN void pip_bit_tree(const uint32_t* B, uint32_t* tbuf, uint32_t* T,
                         int w, int j, int tid, int nthreads) {
  using S = pip_shape<WB, C>;
  constexpr int half = S::kLeaves / 2;
  const uint32_t* Bw = B + static_cast<int64_t>(w) * S::kSlots * PIP_PW;
  uint32_t* tb = tbuf + (static_cast<int64_t>(w) * WB + j) * half * PIP_PW;
  const int low = (1 << j) - 1;
  for (int t = tid; t < half; t += nthreads) {
    const int u = t + half;
    const int b0 = ((t >> j) << (j + 1)) | (1 << j) | (t & low);
    const int b1 = ((u >> j) << (j + 1)) | (1 << j) | (u & low);
    bls_store(tb + t * PIP_PW, pt_add(bls_load<pt<fp>>(Bw + b0 * PIP_PW),
                                      bls_load<pt<fp>>(Bw + b1 * PIP_PW)));
  }
  PIP_BARRIER();
  for (int h = half / 2; h >= 1; h /= 2) {
    for (int t = tid; t < h; t += nthreads) {
      uint32_t* a = tb + t * PIP_PW;
      bls_store(a, pt_add(bls_load<pt<fp>>(a),
                          bls_load<pt<fp>>(a + h * PIP_PW)));
    }
    PIP_BARRIER();
  }
  if (tid == 0)
    for (int k = 0; k < PIP_PW; ++k)
      T[(static_cast<int64_t>(w) * WB + j) * PIP_PW + k] = tb[k];
}

// launch 5: G_w = sum_j 2^j T_j a window (thread tid of nthreads), then
// Horner over the windows, window 0 the most significant
template <int WB, int C>
BLS_FN void pip_horner(const uint32_t* T, uint32_t* G, uint32_t* out,
                       int tid, int nthreads) {
  using S = pip_shape<WB, C>;
  for (int w = tid; w < S::kWindows; w += nthreads) {
    const uint32_t* Tw = T + static_cast<int64_t>(w) * WB * PIP_PW;
    pt<fp> g = bls_load<pt<fp>>(Tw + (WB - 1) * PIP_PW);
    for (int j = WB - 2; j >= 0; --j)
      g = pt_add(pt_double(g), bls_load<pt<fp>>(Tw + j * PIP_PW));
    bls_store(G + w * PIP_PW, g);
  }
  PIP_BARRIER();
  if (tid != 0) return;
  pt<fp> acc = bls_load<pt<fp>>(G);
  for (int w = 1; w < S::kWindows; ++w) {
    for (int i = 0; i < WB; ++i) acc = pt_double(acc);
    acc = pt_add(acc, bls_load<pt<fp>>(G + w * PIP_PW));
  }
  bls_store(out, acc);
}
