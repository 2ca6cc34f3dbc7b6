// K1, the segment sums of G1 or G2 points, on the check kernel's four-warp
// levels: device bodies of bls381_check.cu's `bls381_segment_sum_kernel`.
//
// One block of CHECK_LANES lanes (four warps, one on each of the SM's four
// sub-partitions) sums a segment of L points, L a power of two, by halving
// in place in its device scratch copy: round h = L/2, ..., 1 adds point
// i + h into point i for i < h, and the segment's sum is point 0.  The pair
// order, the formulas (add-2007-bl, dbl-2009-l) and the selects at
// infinity, for equal inputs (which double) and for opposite inputs (which
// give (1, 1, 0)) are bls381.cuh `pt_add`'s, so the Jacobian words equal
// the plain version's (ops/bls381_cuda.py `halving_sum`) bit for bit: each
// coordinate is the same field element whatever the order of its
// products, and every value is canonical.
//
// The first design ran a whole add on one thread, 16 dependent Fq products
// (43 in G2) on the struct layer, so a 128-point segment cost 7 rounds x
// 16 products at about 2 us each.  Here a round's adds go in batches of
// up to SEG_BATCH_G1 (G2: SEG_BATCH_G2) through five product levels, each
// lane of a level computing one Fq product (in G2 one Karatsuba part of an
// Fq2 product or one component of a square) of one add of the batch:
//
//   1. Z1^2, Z2^2, Y1 Z2, Y2 Z1, (Z1 + Z2)^2
//   2. U1 = X1 Z2^2, U2 = X2 Z1^2, S1 = Y1 Z2 Z2^2, S2 = Y2 Z1 Z1^2
//   3. I = (2H)^2, r^2, Z3 = ((Z1 + Z2)^2 - Z1^2 - Z2^2) H
//   4. J = H I, V = U1 I
//   5. r (V - X3), S1 J
//
// Between two product levels a combine level, a lane an add and Fq
// component, puts a G2 product together from its Karatsuba parts and
// computes the sums the next levels read (H = U2 - U1, 2H, r = 2 (S2 -
// S1), X3 = r^2 - J - 2V, V - X3, ...), so a product lane only copies its
// two operands: it picks them from a table (`SEG_PRODUCTS`) on paths that
// call nothing, then the lanes of a warp meet again before the one inline
// product.  (A first form of this design recomputed those sums, with the
// Karatsuba sums, in every product lane: a G2 level took about 10 us, as
// against 2.7 in G1; the table keeps a level's code to a copy, the
// product and a store.)  After level 5 one lane an add selects its case
// and writes the point.  Equal inputs leave point i as it is and raise a
// flag; a batch with a flag runs the doubling's three product levels
// (X^2, Y^2, Y Z; (Y^2)^2, (X + Y^2)^2, (3X^2)^2; E (D - X3)) on the same
// values, behind a branch that __syncthreads_or makes uniform across the
// block.  The dependent chain of a round is five products (eight with a
// doubling) instead of 16 (G2: 43); a level's lanes are assigned product
// by product, so a warp's lanes mostly pick the same operands.
//
// The levels follow bls381_check.cuh's rules: every lane makes the same
// out-of-line call through BLS_LEVEL's gate, picks its operands inline
// (branches there call nothing), runs one inline product on scratch
// operands where it has no work, and stores only where it has; the pointer
// layer (bls381_reg.cuh) only, none of bls381.cuh's struct functions (the
// struct types fp and fp2 only name the field).  A batch's values live in
// shared memory (`seg_smem`: about 33 KB in G1, 28 KB in G2); the points
// stay in the device scratch copy.  On the host the same levels run lane
// after lane.
#pragma once

#include "bls381_check.cuh"

#define SEG_BATCH_G1 32      // a level of 5 G1 products: 160 lanes, 2 passes
#define SEG_BATCH_G2 10      // a level of 12 Fq parts: 120 lanes, 1 pass

// an add's values: its products, then the sums the combine levels derive
enum SegValue {
  SV_Z1Z1, SV_Z2Z2, SV_Y1Z2, SV_Y2Z1, SV_ZS,     // level 1
  SV_U1, SV_U2, SV_S1, SV_S2,                    // level 2
  SV_I, SV_RR, SV_Z3,                            // level 3
  SV_J, SV_V,                                    // level 4
  SV_RV, SV_S1J,                                 // level 5
  SV_ZH,                                         // (Z1 + Z2)^2 - Z1^2 - Z2^2
  SV_H, SV_H2, SV_R,                             // U2 - U1, 2H, 2 (S2 - S1)
  SV_X3, SV_VX,                                  // r^2 - J - 2V, V - X3
  SV_COUNT
};
// the doubling's values, on the same slots (the add's are dead by then)
enum SegDoubleValue {
  SD_A, SD_B, SD_YZ,                             // doubling level 1
  SD_C, SD_T, SD_F,                              // doubling level 2
  SD_EDX,                                        // doubling level 3
  SD_XB, SD_E,                                   // X + Y^2, 3 X^2
  SD_D, SD_X3, SD_DX                             // 2 (T - A - C), F - 2D, D - X3
};
#define SEG_ADD_LEVELS 5
#define SEG_LEVELS 8
#define SEG_LEVEL_WIDTH 5    // products of the widest level

// operand sources: the two points' coordinates, Z1 + Z2, or a value
enum SegSource { SRC_X1, SRC_Y1, SRC_Z1, SRC_X2, SRC_Y2, SRC_Z2, SRC_ZSUM,
                 SRC_VALUE };
#define SV(v) (SRC_VALUE + (v))

// each level's products: {value, is a square, x source, y source} (a
// square's y is x), {-1} past the level's last
BLS_CONST int SEG_PRODUCTS[SEG_LEVELS][SEG_LEVEL_WIDTH][4] = {
    {{SV_Z1Z1, 1, SRC_Z1, 0}, {SV_Z2Z2, 1, SRC_Z2, 0},
     {SV_Y1Z2, 0, SRC_Y1, SRC_Z2}, {SV_Y2Z1, 0, SRC_Y2, SRC_Z1},
     {SV_ZS, 1, SRC_ZSUM, 0}},
    {{SV_U1, 0, SRC_X1, SV(SV_Z2Z2)}, {SV_U2, 0, SRC_X2, SV(SV_Z1Z1)},
     {SV_S1, 0, SV(SV_Y1Z2), SV(SV_Z2Z2)},
     {SV_S2, 0, SV(SV_Y2Z1), SV(SV_Z1Z1)}, {-1}},
    {{SV_I, 1, SV(SV_H2), 0}, {SV_RR, 1, SV(SV_R), 0},
     {SV_Z3, 0, SV(SV_ZH), SV(SV_H)}, {-1}, {-1}},
    {{SV_J, 0, SV(SV_H), SV(SV_I)}, {SV_V, 0, SV(SV_U1), SV(SV_I)}, {-1},
     {-1}, {-1}},
    {{SV_RV, 0, SV(SV_R), SV(SV_VX)}, {SV_S1J, 0, SV(SV_S1), SV(SV_J)}, {-1},
     {-1}, {-1}},
    {{SD_A, 1, SRC_X1, 0}, {SD_B, 1, SRC_Y1, 0},
     {SD_YZ, 0, SRC_Y1, SRC_Z1}, {-1}, {-1}},
    {{SD_C, 1, SV(SD_B), 0}, {SD_T, 1, SV(SD_XB), 0},
     {SD_F, 1, SV(SD_E), 0}, {-1}, {-1}},
    {{SD_EDX, 0, SV(SD_E), SV(SD_DX)}, {-1}, {-1}, {-1}, {-1}}};

// words of a field element of F (fp: 12, fp2: 24)
template <typename F>
struct seg_field {
  static constexpr int FW = static_cast<int>(sizeof(F) / 4);
  static constexpr int C = FW / RQ_W;            // Fq components
};

template <typename F>
struct seg_smem {
  static constexpr int kBatch =
      seg_field<F>::FW == RQ_W ? SEG_BATCH_G1 : SEG_BATCH_G2;
  uint32_t val[kBatch][SV_COUNT][seg_field<F>::FW];   // each add's values
  // a G2 level's Karatsuba parts, by product of the level (unused in G1)
  uint32_t part[seg_field<F>::C == 1 ? 1 : kBatch]
               [seg_field<F>::C == 1 ? 1 : SEG_LEVEL_WIDTH][3][RQ_W];
  uint8_t eq[kBatch];                                 // equal inputs: double
};

// the lanes a product takes: one in G1; in G2 a square's two components
// or a product's three Karatsuba parts
template <typename F>
BLS_FN int seg_parts(bool sqr) {
  if constexpr (seg_field<F>::C == 1) return 1;
  else return sqr ? 2 : 3;
}

// a copy of a field element, unrolled: every index is static, so the
// operand arrays stay in registers
template <typename F>
BLS_FN void fe_copy(uint32_t* r, const uint32_t* a) {
#pragma unroll
  for (int i = 0; i < seg_field<F>::FW; ++i) r[i] = a[i];
}

template <typename F>
BLS_FN bool fe_is_zero(const uint32_t* a) {
  if constexpr (seg_field<F>::C == 1) return rq_is_zero(a);
  else return r2_is_zero(a);
}

// operand `src` of an add (p1, p2, its values v)
template <typename F>
BLS_FN void seg_fetch(uint32_t* out, int src, const uint32_t* p1,
                      const uint32_t* p2,
                      const uint32_t (*v)[seg_field<F>::FW]) {
  constexpr int FW = seg_field<F>::FW;
  if (src >= SRC_VALUE) {
    fe_copy<F>(out, v[src - SRC_VALUE]);
  } else if (src == SRC_ZSUM) {
    if constexpr (seg_field<F>::C == 1) rq_add(out, p1 + 2 * FW, p2 + 2 * FW);
    else r2_add(out, p1 + 2 * FW, p2 + 2 * FW);
  } else {
    fe_copy<F>(out, (src < SRC_X2 ? p1 : p2) + (src % 3) * FW);
  }
}

// the Fq operands u, v of part `part` of the G2 product x y (a square's y
// is x): a Karatsuba part x0 y0, x1 y1 or (x0 + x1)(y0 + y1), or a
// square's component (x0 + x1)(x0 - x1) or 2 x0 x1 (doubled after the
// product).  bls381_check.cuh `fq_part` with the part taken by select: an
// index by `part` would put x and y in local memory.
BLS_FN void seg_part2(uint32_t* u, uint32_t* v, bool sqr, int part,
                      const uint32_t* x, const uint32_t* y) {
  uint32_t sx[RQ_W], sy[RQ_W], dx[RQ_W];
  rq_add(sx, x, x + RQ_W);
  rq_add(sy, y, y + RQ_W);
  rq_sub(dx, x, x + RQ_W);
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) {
    if (sqr) {
      u[i] = part == 0 ? sx[i] : x[i];
      v[i] = part == 0 ? dx[i] : x[RQ_W + i];
    } else {
      u[i] = part == 0 ? x[i] : (part == 1 ? x[RQ_W + i] : sx[i]);
      v[i] = part == 0 ? y[i] : (part == 1 ? y[RQ_W + i] : sy[i]);
    }
  }
}

// On the card the lanes of a warp meet again before a level's product:
// they pick their operands on paths that diverge, and the compiler must
// not sink the product into those paths, where each path of a warp would
// run its own copy of it in turn.
#if defined(__CUDACC__)
#define SEG_CONVERGE() __syncwarp()
#else
#define SEG_CONVERGE() do { } while (0)
#endif

// ---------------------------------------------------------------------------
// the levels
// ---------------------------------------------------------------------------

// product level `level` of the batch [b0, b0 + nb) of round h: item it =
// (lane k of the level's products, add a) with a = it % nb, so a warp's
// lanes mostly share a product; every lane runs one inline product a pass
// and stores it where it is an item (a G1 product or a G2 square's
// component as the value, a G2 product's Karatsuba part for the combine)
template <typename F>
BLS_CALL void seg_level(int lane, seg_smem<F>* s, const uint32_t* seg,
                        int64_t h, int64_t b0, int nb, int level) {
  constexpr int FW = seg_field<F>::FW;
  int parts = 0;
  for (int p = 0; p < SEG_LEVEL_WIDTH && SEG_PRODUCTS[level][p][0] >= 0; ++p)
    parts += seg_parts<F>(SEG_PRODUCTS[level][p][1] != 0);
  const int total = parts * nb;
  for (int base = 0; base < total; base += CHECK_LANES) {
    const int it = base + lane;
    const bool live = it < total;
    int k = (live ? it : 0) / nb;
    const int a = (live ? it : 0) % nb;
    int p = 0;
    while (k >= seg_parts<F>(SEG_PRODUCTS[level][p][1] != 0)) {
      k -= seg_parts<F>(SEG_PRODUCTS[level][p][1] != 0);
      ++p;
    }
    const int value = SEG_PRODUCTS[level][p][0];
    const bool sqr = SEG_PRODUCTS[level][p][1] != 0;
    const int64_t i = b0 + a;
    const uint32_t* p1 = seg + i * 3 * FW;
    const uint32_t* p2 = seg + (i + h) * 3 * FW;
    uint32_t x[FW], y[FW], w[RQ_W];
    seg_fetch<F>(x, SEG_PRODUCTS[level][p][2], p1, p2, s->val[a]);
    if (sqr) fe_copy<F>(y, x);
    else seg_fetch<F>(y, SEG_PRODUCTS[level][p][3], p1, p2, s->val[a]);
    uint32_t* dst;
    if constexpr (FW == RQ_W) {
      SEG_CONVERGE();
      rq_mul(w, x, y);
      dst = s->val[a][value];
    } else {
      uint32_t u[RQ_W], v[RQ_W];
      seg_part2(u, v, sqr, k, x, y);
      SEG_CONVERGE();
      rq_mul(w, u, v);
      if (sqr && k == 1) rq_add(w, w, w);
      dst = sqr ? s->val[a][value] + k * RQ_W : s->part[a][p][k];
    }
    if (live) {
#pragma unroll
      for (int j = 0; j < RQ_W; ++j) dst[j] = w[j];
    }
  }
}

// the combine level after product level `level`, lane = (add a, Fq
// component c) for a < nb: the level's G2 products from their Karatsuba
// parts (component c of (v0 - v1, v2 - v0 - v1)), then component c of the
// sums the next levels read; Fq2 sums go component by component
template <typename F>
BLS_CALL void seg_combine(int lane, seg_smem<F>* s, const uint32_t* seg,
                          int64_t b0, int nb, int level) {
  constexpr int FW = seg_field<F>::FW, C = seg_field<F>::C;
  if (lane >= nb * C) return;
  const int a = lane / C, c = lane % C;
  uint32_t (*v)[FW] = s->val[a];
  if constexpr (C == 2) {
    for (int p = 0; p < SEG_LEVEL_WIDTH && SEG_PRODUCTS[level][p][0] >= 0;
         ++p) {
      if (SEG_PRODUCTS[level][p][1]) continue;
      const uint32_t (*q)[RQ_W] = s->part[a][p];
      uint32_t* out = v[SEG_PRODUCTS[level][p][0]] + c * RQ_W;
      uint32_t t[RQ_W];
      if (c == 0) {
        rq_sub(out, q[0], q[1]);
      } else {
        rq_add(t, q[0], q[1]);
        rq_sub(out, q[2], t);
      }
    }
  }
  const int o = c * RQ_W;
  uint32_t t[RQ_W];
  switch (level) {
    case 0:                                         // ZH
      rq_sub(v[SV_ZH] + o, v[SV_ZS] + o, v[SV_Z1Z1] + o);
      rq_sub(v[SV_ZH] + o, v[SV_ZH] + o, v[SV_Z2Z2] + o);
      break;
    case 1:                                         // H, 2H, r
      rq_sub(v[SV_H] + o, v[SV_U2] + o, v[SV_U1] + o);
      rq_add(v[SV_H2] + o, v[SV_H] + o, v[SV_H] + o);
      rq_sub(t, v[SV_S2] + o, v[SV_S1] + o);
      rq_add(v[SV_R] + o, t, t);
      break;
    case 3:                                         // X3, V - X3
      rq_sub(t, v[SV_RR] + o, v[SV_J] + o);
      rq_sub(t, t, v[SV_V] + o);
      rq_sub(v[SV_X3] + o, t, v[SV_V] + o);
      rq_sub(v[SV_VX] + o, v[SV_V] + o, v[SV_X3] + o);
      break;
    case SEG_ADD_LEVELS: {                          // X + Y^2, 3 X^2
      const uint32_t* X1 = seg + (b0 + a) * 3 * FW;
      rq_add(v[SD_XB] + o, X1 + o, v[SD_B] + o);
      rq_add(t, v[SD_A] + o, v[SD_A] + o);
      rq_add(v[SD_E] + o, t, v[SD_A] + o);
      break;
    }
    case SEG_ADD_LEVELS + 1:                        // D, X3, D - X3
      rq_sub(t, v[SD_T] + o, v[SD_A] + o);
      rq_sub(t, t, v[SD_C] + o);
      rq_add(v[SD_D] + o, t, t);
      rq_add(t, v[SD_D] + o, v[SD_D] + o);
      rq_sub(v[SD_X3] + o, v[SD_F] + o, t);
      rq_sub(v[SD_DX] + o, v[SD_D] + o, v[SD_X3] + o);
      break;
    default:
      break;
  }
}

// whether combine level `level` has work: a G2 product to put together or
// sums to derive
template <typename F>
BLS_FN bool seg_combines(int level) {
  if (level == 0 || level == 1 || level == 3 || level == SEG_ADD_LEVELS ||
      level == SEG_ADD_LEVELS + 1)
    return true;
  if constexpr (seg_field<F>::C == 1) return false;
  else return level == 2 || level == 4 || level == SEG_LEVELS - 1;
}

// after level 5 (and its combine), lane a < nb: point b0 + a becomes the
// sum (X3, r (V - X3) - 2 S1 J, Z3), p1 where p2 is infinity, p2 where p1
// is, (1, 1, 0) for opposite points; equal points stay for the doubling
// and set eq[a]
template <typename F>
BLS_CALL void seg_add_finish(int lane, seg_smem<F>* s, uint32_t* seg,
                             int64_t h, int64_t b0, int nb) {
  constexpr int FW = seg_field<F>::FW;
  if (lane >= nb) return;
  const uint32_t (*v)[FW] = s->val[lane];
  uint32_t* p1 = seg + (b0 + lane) * 3 * FW;
  const uint32_t* p2 = seg + (b0 + lane + h) * 3 * FW;
  uint32_t o[3 * FW], t[FW];
  fe_copy<F>(o, v[SV_X3]);
  fe_copy<F>(t, v[SV_S1J]);
  if constexpr (seg_field<F>::C == 1) {
    rq_add(t, t, t);
    rq_sub(o + FW, v[SV_RV], t);
  } else {
    r2_add(t, t, t);
    r2_sub(o + FW, v[SV_RV], t);
  }
  fe_copy<F>(o + 2 * FW, v[SV_Z3]);
  const bool h0 = fe_is_zero<F>(v[SV_H]);
  const bool r0 = fe_is_zero<F>(v[SV_R]);     // 2 (S2 - S1): S2 == S1
  const bool inf1 = fe_is_zero<F>(p1 + 2 * FW);
  const bool inf2 = fe_is_zero<F>(p2 + 2 * FW);
  const bool eq = !inf1 && !inf2 && h0 && r0;
  s->eq[lane] = eq ? 1 : 0;
#pragma unroll
  for (int w = 0; w < 3 * FW; ++w) {
    // infinity (1, 1, 0): one in the first Fq words of X and Y
    const uint32_t inf_w = (w < RQ_W) ? BLS_ONE[w]
        : (w >= FW && w < FW + RQ_W) ? BLS_ONE[w - FW] : 0u;
    const uint32_t sum_w = h0 ? inf_w : o[w];
    const uint32_t r = inf2 ? p1[w] : (inf1 ? p2[w] : sum_w);
    if (!eq) p1[w] = r;
  }
}

// after the doubling's levels, lane a < nb with eq[a]: point b0 + a
// becomes 2 p1 (X3 = F - 2D, Y3 = E (D - X3) - 8C, Z3 = 2 Y Z)
template <typename F>
BLS_CALL void seg_dbl_finish(int lane, seg_smem<F>* s, uint32_t* seg,
                             int64_t b0, int nb) {
  constexpr int FW = seg_field<F>::FW;
  if (lane >= nb || !s->eq[lane]) return;
  const uint32_t (*v)[FW] = s->val[lane];
  uint32_t* p1 = seg + (b0 + lane) * 3 * FW;
  uint32_t t[FW];
  fe_copy<F>(p1, v[SD_X3]);
  fe_copy<F>(t, v[SD_C]);
  if constexpr (seg_field<F>::C == 1) {
    rq_add(t, t, t);
    rq_add(t, t, t);
    rq_add(t, t, t);
    rq_sub(p1 + FW, v[SD_EDX], t);
    rq_add(p1 + 2 * FW, v[SD_YZ], v[SD_YZ]);
  } else {
    r2_add(t, t, t);
    r2_add(t, t, t);
    r2_add(t, t, t);
    r2_sub(p1 + FW, v[SD_EDX], t);
    r2_add(p1 + 2 * FW, v[SD_YZ], v[SD_YZ]);
  }
}

// whether any add of the batch had equal inputs (the same answer on every
// lane: a branch on it does not diverge)
template <typename F>
BLS_FN bool seg_any_equal(const seg_smem<F>* s, int nb) {
#if defined(__CUDACC__)
  return __syncthreads_or(static_cast<int>(threadIdx.x) < nb &&
                          s->eq[threadIdx.x]) != 0;
#else
  for (int a = 0; a < nb; ++a)
    if (s->eq[a]) return true;
  return false;
#endif
}

// product level `level` of a batch, then its combine level where it has one
template <typename F>
BLS_FN void seg_step(seg_smem<F>* s, uint32_t* seg, int64_t h, int64_t b0,
                     int nb, int level) {
  BLS_LEVEL(seg_level<F>(lane, s, seg, h, b0, nb, level));
  if (seg_combines<F>(level))
    BLS_LEVEL(seg_combine<F>(lane, s, seg, b0, nb, level));
}

// a segment of len points (3 * seg_field<F>::FW words each) summed in place
// in seg, its sum written to out
template <typename F>
BLS_FN void segment_job(seg_smem<F>* s, uint32_t* seg, int64_t len,
                        uint32_t* out) {
  constexpr int FW = seg_field<F>::FW;
  constexpr int64_t batch = seg_smem<F>::kBatch;
  for (int64_t h = len / 2; h >= 1; h /= 2) {
    for (int64_t b0 = 0; b0 < h; b0 += batch) {
      const int nb = static_cast<int>(h - b0 < batch ? h - b0 : batch);
      for (int level = 0; level < SEG_ADD_LEVELS; ++level)
        seg_step<F>(s, seg, h, b0, nb, level);
      BLS_LEVEL(seg_add_finish<F>(lane, s, seg, h, b0, nb));
      if (seg_any_equal<F>(s, nb)) {
        for (int level = SEG_ADD_LEVELS; level < SEG_LEVELS; ++level)
          seg_step<F>(s, seg, h, b0, nb, level);
        BLS_LEVEL(seg_dbl_finish<F>(lane, s, seg, b0, nb));
      }
    }
  }
  BLS_LEVEL(if (lane < 3 * FW) out[lane] = seg[lane]);
}
