// The batched pairing check, one block of four warps a job: device bodies of
// bls381_check.cu.
//
// A job is k pairs (P_i, Q_i) and its verdict prod_i e(P_i, Q_i) == 1.  The
// job's state lives in shared memory (`check_smem`): its Fq12 accumulator,
// the Fq12 temporaries of the final exponentiation, the products and sums
// of one tower level, and a chunk of pairs' lines and Miller temporaries;
// the pairs' Jacobian twist points T_i stay in a device scratch array, 72
// words a pair, so k is not bounded by shared memory.
//
// Each cooperative step is a level: a per-lane body `lvl_*(lane, s, ...)`
// that reads the job's shared arrays, computes at most one Fq2 product
// (3 Fq products) or a few additions on its lane, and writes its result
// back.  BLS_LEVEL runs a level on every lane of the job and ends it with a
// barrier; without __CUDACC__ it runs the lanes in turn, so the host
// C++ build runs the same levels in the same order.  A job is four warps
// (CHECK_LANES = 128 lanes, one on each of the SM's four sub-partitions):
// one warp's products are bound by its sub-partition's multiply pipe
// (about 2 us a dependent Fq product whatever its form, measured on the
// card), so the work of a level is spread over lanes, an Fq product a lane
// where the level is wide, f^2 runs on two warps beside the first chunk's
// doubling steps on the other two, and the barrier is __syncthreads().
// Every lane of a level makes the same out-of-line calls: a lane picks its
// operands (inline code may branch), all lanes run the one product, lanes
// without work on scratch operands, and a lane then stores or combines its
// result inline (see BLS_LEVEL for why).  The levels:
//
// - Fq12 product, 3 levels: 54 lanes each an Fq product (a Karatsuba part
//   of the 18 Fq2 products of the Karatsuba-over-Karatsuba scheme), 18
//   lanes each an Fq coefficient of the three Fq6 products, 12 lanes each
//   an Fq coefficient of the result;
// - cyclotomic square (Granger-Scott), 2 levels: the 18 Fq products of its
//   9 Fq2 squares, then 12 Fq coefficients;
// - Frobenius, conjugate, copy: one level of 6 or 12 lanes;
// - Miller doubling step, 4 levels for a chunk of CHECK_CHUNK pairs: 11,
//   15 and 8 lanes a pair each computing one Fq product, then 6 lanes a
//   pair adding up the line and the new point; the adding step, 6 levels
//   of up to 5 lanes a pair each computing one Fq2 product;
// - the Fq12 inverse, one level on lane 0 (its Fq inverse is ~570 dependent
//   products: the job's one serial stretch).
//
// The Miller loop keeps one accumulator for the job: f <- f^2 prod_i l_i
// over the live pairs of each bit, conjugated once at the end (x < 0).  Fq12
// is commutative and conjugation is a ring automorphism, so f equals the
// product of the per-pair Miller values, as a field element and so bit for
// bit.  The job is three parts, `check_miller`, the store and
// `check_final`; the pairing's two launches run the same parts (a pair's
// Miller value at k = 1 a block, then a job's product and final
// exponentiation, bls381_pairing.cuh).  The lines and the twist points
// follow the plain version's `_double_step` / `_add_step`
// (ops/pairing_torch.py) formula for formula (their values set the
// product); the final exponentiation follows its `_easy_part` and
// `_hard_chain`.
#pragma once

#include "bls381_reg.cuh"

#define CHECK_CHUNK 4        // pairs whose steps share a level
#define CHECK_LANES 128      // four warps a job: four sub-partitions' multipliers
#define CHECK_HALF 64        // lanes of each of the two warp pairs
#define RQ12_W 144           // words of an Fq12 element

#if defined(__CUDACC__) && !defined(BLS_LEVEL_UNGATED)
// Every lane enters a level through a test of its entry in this gate, which
// is zero (device memory is zero-initialised) and which nothing writes.
// Built without the test (-DBLS_LEVEL_UNGATED), the check faults on the
// card (an illegal or misaligned address) with nvcc 12.9 for sm_90a,
// although every level equals its host build, which runs the lanes in
// turn; scripts/torch_check_gate_repro.py builds both forms and runs them.
// The cause is not known.  One hypothesis, from the SASS: ptxas treats the
// level calls as warp-uniform and passes their pointers in uniform
// registers; a per-lane test it cannot prove uniform keeps them per-lane.
// The gate is defined here, so one translation unit of the library
// includes this header: bls381_check.cu, which holds the check's kernel and
// the pairing's two.
__device__ int bls_level_gate[CHECK_LANES];
#define BLS_LEVEL(call)                                                    \
  do {                                                                     \
    if (bls_level_gate[threadIdx.x] == 0) {                                \
      const int lane = static_cast<int>(threadIdx.x);                      \
      call;                                                                \
    }                                                                      \
    __syncthreads();                                                       \
  } while (0)
#elif defined(__CUDACC__)
#define BLS_LEVEL(call)                                                    \
  do {                                                                     \
    {                                                                      \
      const int lane = static_cast<int>(threadIdx.x);                      \
      call;                                                                \
    }                                                                      \
    __syncthreads();                                                       \
  } while (0)
#else
#define BLS_LEVEL(call)                                                    \
  do {                                                                     \
    for (int lane = 0; lane < CHECK_LANES; ++lane) {                       \
      call;                                                                \
    }                                                                      \
  } while (0)
#endif

// a chunk slot's Miller temporaries (Fq2 each); the doubling and the adding
// step reuse the same slots
enum MillerTmp {
  MT_X2, MT_Y2, MT_Z2, MT_YYP, MT_C, MT_T, MT_FV, MT_C1, MT_COUNT,
  // the adding step
  MA_ZZ = 0, MA_YZ1, MA_U2, MA_S2, MA_ZL, MA_TX, MA_HH, MA_R2, MA_J, MA_V,
  MA_RV, MA_YJ, MA_XN, MA_COUNT
};
#define CHECK_TMP 13         // max(MT_COUNT, MA_COUNT)
#define CHECK_MP 6           // MP_COUNT

// Fq12 slots of the final exponentiation: the accumulator, then t0..t6
enum CheckSlot { CS_F, CS_T0, CS_T1, CS_T2, CS_T3, CS_T4, CS_T5, CS_T6,
                 CS_COUNT };

// an Fq12 product's intermediates between its three levels
struct mul_smem {
  uint32_t parts[18][3][RQ_W];               // its Fq parts
  uint32_t sums[9][RQ2_W];                   // its Fq6 coefficients
};

struct check_smem {
  uint32_t w[CS_COUNT][RQ12_W];              // Fq12 slots
  uint32_t cyc[9][RQ2_W];                    // a cyclotomic square's squares
  mul_smem mul;                              // an Fq12 product's levels
  uint32_t line[CHECK_CHUNK][RQ12_W];        // sparse lines as Fq12
  uint32_t tmp[CHECK_CHUNK][CHECK_TMP][RQ2_W];
  uint32_t mparts[CHECK_CHUNK][CHECK_MP][3][RQ_W];   // Karatsuba parts
};

// Fq2 coefficient j (0..5) of an Fq12 in layout order c0.c0, c0.c1, c0.c2,
// c1.c0, c1.c1, c1.c2
#define FQ12_C(a, j) ((a) + (j) * RQ2_W)

// ---------------------------------------------------------------------------
// Fq12 product r = a b: v0 = a0 b0, v1 = a1 b1, v2 = (a0 + a1)(b0 + b1)
// over Fq6 (Karatsuba), each an Fq6 Karatsuba-CH of six Fq2 products
// (x0y0, x1y1, x2y2, (x0 + x1)(y0 + y1), (x0 + x2)(y0 + y2),
// (x1 + x2)(y1 + y2)); r.c0 = v0 + v v1, r.c1 = v2 - v0 - v1.
// ---------------------------------------------------------------------------

// Fq2 coefficient j of Fq6 operand m (0: a.c0, 1: a.c1, 2: a.c0 + a.c1)
BLS_FN void kara6_coef(uint32_t* out, const uint32_t* a, int m, int j) {
  if (m < 2) rq_copy(out, FQ12_C(a, 3 * m + j), RQ2_W);
  else r2_add(out, FQ12_C(a, j), FQ12_C(a, 3 + j));
}

// the Fq2 operand of product t (0..5) of Fq6 operand m
BLS_FN void kara_operand(uint32_t* out, const uint32_t* a, int m, int t) {
  if (t < 3) {
    kara6_coef(out, a, m, t);
    return;
  }
  uint32_t u[RQ2_W];
  const int i = t == 5 ? 1 : 0, j = t == 3 ? 1 : 2;
  kara6_coef(out, a, m, i);
  kara6_coef(u, a, m, j);
  r2_add(out, out, u);
}

// level 1: lane = 3 P + part, 54 lanes, one Fq product each: part 0, 1, 2
// of Fq2 product P = 6 m + t (Karatsuba: x0 y0, x1 y1, (x0 + x1)(y0 + y1)),
// rebuilt where it is read (kara_fq2).  Lanes 54..63 repeat lanes 0..9 and
// store nothing; the product is inline, so the level calls nothing.
BLS_CALL void lvl_mul_products(int lane, mul_smem* s, const uint32_t* a,
                               const uint32_t* b) {
  const int l = lane % 54, P = l / 3, part = l % 3;
  uint32_t x[RQ2_W], y[RQ2_W], u[RQ_W], v[RQ_W];
  kara_operand(x, a, P / 6, P % 6);
  kara_operand(y, b, P / 6, P % 6);
  if (part < 2) {
    rq_copy(u, x + part * RQ_W, RQ_W);
    rq_copy(v, y + part * RQ_W, RQ_W);
  } else {
    rq_add(u, x, x + RQ_W);
    rq_add(v, y, y + RQ_W);
  }
  rq_mul(u, u, v);
  if (lane < 54) rq_copy(s->parts[P][part], u, RQ_W);
}

// Fq2 product P from its Karatsuba parts: (v0 - v1, v2 - v0 - v1)
BLS_FN void kara_fq2(uint32_t* out, const uint32_t (*v)[RQ_W]) {
  uint32_t t[RQ_W];
  rq_add(t, v[0], v[1]);
  rq_sub(out, v[0], v[1]);
  rq_sub(out + RQ_W, v[2], t);
}

// level 2: lane = 2 (3 m + j) + c, 18 lanes: component c of coefficient j
// of Fq6 product m, from its six products p: c0 = p0 + XI (p5 - p1 - p2),
// c1 = p3 - p0 - p1 + XI p2, c2 = p4 - p0 - p2 + p1
BLS_CALL void lvl_mul_sums(int lane, mul_smem* s) {
  if (lane >= 18) return;
  const int m = lane / 6, j = (lane / 2) % 3, o = (lane & 1) * RQ_W;
  uint32_t p[6][RQ2_W];
  for (int t = 0; t < 6; ++t) kara_fq2(p[t], s->parts[6 * m + t]);
  uint32_t x[RQ_W], d0[RQ_W], d1[RQ_W];
  if (j == 0) {                        // p0 + XI (p5 - p1 - p2)
    rq_sub(d0, p[5], p[1]);
    rq_sub(d0, d0, p[2]);
    rq_sub(d1, p[5] + RQ_W, p[1] + RQ_W);
    rq_sub(d1, d1, p[2] + RQ_W);
    if (o == 0) rq_sub(x, d0, d1);
    else rq_add(x, d0, d1);
    rq_add(x, x, p[0] + o);
  } else if (j == 1) {                 // p3 - p0 - p1 + XI p2
    if (o == 0) rq_sub(x, p[2], p[2] + RQ_W);
    else rq_add(x, p[2], p[2] + RQ_W);
    rq_add(x, x, p[3] + o);
    rq_sub(x, x, p[0] + o);
    rq_sub(x, x, p[1] + o);
  } else {                             // p4 - p0 - p2 + p1
    rq_sub(x, p[4] + o, p[0] + o);
    rq_sub(x, x, p[2] + o);
    rq_add(x, x, p[1] + o);
  }
  rq_copy(s->sums[3 * m + j] + o, x, RQ_W);
}

// level 3: lane = 2 o + c, 12 lanes: component c of output coefficient o;
// r.c0 = V0 + v V1 (v V1 = (XI V1.c2, V1.c0, V1.c1)), r.c1 = V2 - V0 - V1
BLS_CALL void lvl_mul_out(int lane, mul_smem* s, uint32_t* r) {
  if (lane >= 12) return;
  const int o = lane / 2, c = lane & 1;
  uint32_t(*V)[RQ2_W] = s->sums;       // V[3 m + j]
  uint32_t x[RQ_W];
  if (o == 0) {
    const uint32_t* t = V[3 + 2];
    if (c == 0) rq_sub(x, t, t + RQ_W);
    else rq_add(x, t, t + RQ_W);
    rq_add(x, x, V[0] + c * RQ_W);
  } else if (o < 3) {
    rq_add(x, V[o] + c * RQ_W, V[3 + o - 1] + c * RQ_W);
  } else {
    const int j = o - 3;
    rq_sub(x, V[6 + j] + c * RQ_W, V[j] + c * RQ_W);
    rq_sub(x, x, V[3 + j] + c * RQ_W);
  }
  rq_copy(FQ12_C(r, o) + c * RQ_W, x, RQ_W);
}

// ---------------------------------------------------------------------------
// cyclotomic square (bls381.cuh fp12_cyc_sqr): layout coefficients 0..5 are
// z0, z4, z3, z2, z1, z5; squares of z0, z1, z0 + z1, z2, z3, z2 + z3, z4,
// z5, z4 + z5
// ---------------------------------------------------------------------------

// layout index of z_i: z0 0, z1 4, z2 3, z3 2, z4 1, z5 5
BLS_FN int cyc_pos(int i) { return (i == 0 || i == 5) ? i : 5 - i; }

// component c of the new z_o from the squares sq of a and a's z_o
// (component c of it only): lo_k = XI s_{3k+1} + s_{3k}, hi_k = s_{3k+2} -
// s_{3k} - s_{3k+1}; z0n = 3 lo0 - 2 z0, z1n = 3 hi0 + 2 z1, z4n = 3 lo1 -
// 2 z4, z5n = 3 hi1 + 2 z5, z2n = 3 XI hi2 + 2 z2, z3n = 3 lo2 - 2 z3 (each
// 2 (t -/+ z) + t)
BLS_FN void cyc_new(uint32_t* x, const uint32_t (*sq)[RQ2_W],
                    const uint32_t* a, int o, int c) {
  // which Fq4 square, lo or hi, and whether XI applies to hi
  const int k = o == 0 || o == 1 ? 0 : (o == 4 || o == 5 ? 1 : 2);
  const bool use_lo = o == 0 || o == 4 || o == 3;
  sq += 3 * k;
  uint32_t t[RQ2_W];
  if (use_lo) {
    r2_mul_xi(t, sq[1]);
    r2_add(t, t, sq[0]);
  } else {
    r2_sub(t, sq[2], sq[0]);
    r2_sub(t, t, sq[1]);
    if (o == 2) r2_mul_xi(t, t);
  }
  const uint32_t* z = FQ12_C(a, cyc_pos(o)) + c * RQ_W;
  if (use_lo) rq_sub(x, t + c * RQ_W, z);
  else rq_add(x, t + c * RQ_W, z);
  rq_add(x, x, x);
  rq_add(x, x, t + c * RQ_W);
}

// one Fq product of the squares of (z_lo, z_hi, z_lo + z_hi) of Fq4 k:
// component c of x^2 = ((x0 + x1)(x0 - x1), 2 x0 x1), into sq[3 k + t]
BLS_FN void cyc_square_part(uint32_t* out, const uint32_t* zlo,
                            const uint32_t* zhi, int t, int c) {
  uint32_t x[RQ2_W], u[RQ_W], v[RQ_W];
  if (t == 0) rq_copy(x, zlo, RQ2_W);
  else if (t == 1) rq_copy(x, zhi, RQ2_W);
  else r2_add(x, zlo, zhi);
  if (c == 0) {
    rq_add(u, x, x + RQ_W);
    rq_sub(v, x, x + RQ_W);
  } else {
    rq_copy(u, x, RQ_W);
    rq_copy(v, x + RQ_W, RQ_W);
  }
  rq_mul(out, u, v);
  if (c == 1) rq_add(out, out, out);
}

// level 1: lane = 2 (3 k + t) + c, 18 lanes, one Fq product each: the 9
// Fq2 squares of a's Fq4 pairs (z0, z1), (z2, z3), (z4, z5) (lanes 18..127
// repeat lanes and store nothing); the product is inline, so the level
// calls nothing
BLS_CALL void lvl_cyc_products(int lane, uint32_t (*sq)[RQ2_W],
                               const uint32_t* a) {
  const int l = lane % 18, k = l / 6, t = (l / 2) % 3, c = l & 1;
  uint32_t w[RQ_W];
  cyc_square_part(w, FQ12_C(a, cyc_pos(2 * k)), FQ12_C(a, cyc_pos(2 * k + 1)),
                  t, c);
  if (lane < 18) rq_copy(sq[l / 2] + c * RQ_W, w, RQ_W);
}

// level 2: lane = 2 o + c, 12 lanes: component c of z_o of the square
// (cyc_new); r may alias a (each lane reads the words it writes)
BLS_CALL void lvl_cyc_out(int lane, const uint32_t (*sq)[RQ2_W],
                          const uint32_t* a, uint32_t* r) {
  if (lane >= 12) return;
  const int o = lane / 2, c = lane & 1;
  uint32_t x[RQ_W];
  cyc_new(x, sq, a, o, c);
  rq_copy(FQ12_C(r, cyc_pos(o)) + c * RQ_W, x, RQ_W);
}

// ---------------------------------------------------------------------------
// Frobenius, conjugate, copy, one
// ---------------------------------------------------------------------------

// lanes 0..5: coefficient j <- conj(a_j) FROB_j, `power` times; r may
// alias a (lanes 6..31 repeat lane % 6 and store nothing)
BLS_CALL void lvl_frob(int lane, uint32_t* r, const uint32_t* a, int power) {
  const int j = lane % 6;
  uint32_t x[RQ2_W], g[RQ2_W];
  rq_copy(x, FQ12_C(a, j), RQ2_W);
  for (int i = 0; i < RQ_W; ++i) {
    g[i] = BLS_FROB[j][0][i];
    g[RQ_W + i] = BLS_FROB[j][1][i];
  }
  for (int p = 0; p < power; ++p) {
    r2_conj(x, x);
    r2_mul(x, x, g);
  }
  if (lane < 6) rq_copy(FQ12_C(r, j), x, RQ2_W);
}

// lanes 0..11, an Fq coefficient each: r = conj(a) (c1 negated) or a copy
BLS_CALL void lvl_conj(int lane, uint32_t* r, const uint32_t* a, bool neg) {
  if (lane >= 12) return;
  if (neg && lane >= 6) rq_neg(r + lane * RQ_W, a + lane * RQ_W);
  else rq_copy(r + lane * RQ_W, a + lane * RQ_W, RQ_W);
}

// ---------------------------------------------------------------------------
// Fq12 inverse on lane 0 (bls381.cuh fp12_inv, fp6_inv, fp2_inv), through
// the Fq2 functions and the job's scratch
// ---------------------------------------------------------------------------

// Fq6 product (Karatsuba-CH), r may alias a or b
BLS_FN void r6_mul(uint32_t* r, const uint32_t* a, const uint32_t* b,
                   uint32_t (*t)[RQ2_W]) {
  uint32_t x[RQ2_W], y[RQ2_W];
  r2_mul(t[0], a, b);
  r2_mul(t[1], a + RQ2_W, b + RQ2_W);
  r2_mul(t[2], a + 2 * RQ2_W, b + 2 * RQ2_W);
  r2_add(x, a, a + RQ2_W);
  r2_add(y, b, b + RQ2_W);
  r2_mul(t[3], x, y);                         // t01
  r2_add(x, a, a + 2 * RQ2_W);
  r2_add(y, b, b + 2 * RQ2_W);
  r2_mul(t[4], x, y);                         // t02
  r2_add(x, a + RQ2_W, a + 2 * RQ2_W);
  r2_add(y, b + RQ2_W, b + 2 * RQ2_W);
  r2_mul(t[5], x, y);                         // t12
  // c0 = v0 + XI (t12 - v1 - v2)
  r2_sub(x, t[5], t[1]);
  r2_sub(x, x, t[2]);
  r2_mul_xi(x, x);
  r2_add(r, t[0], x);
  // c1 = t01 - v0 - v1 + XI v2
  r2_sub(x, t[3], t[0]);
  r2_sub(x, x, t[1]);
  r2_mul_xi(y, t[2]);
  r2_add(r + RQ2_W, x, y);
  // c2 = t02 - v0 - v2 + v1
  r2_sub(x, t[4], t[0]);
  r2_sub(x, x, t[2]);
  r2_add(r + 2 * RQ2_W, x, t[1]);
}

// every lane computes the inverse (the same calls on all lanes); lane 0
// stores it
BLS_CALL void lvl_inv(int lane, uint32_t* r, const uint32_t* a) {
  uint32_t t[6][RQ2_W];                       // r6_mul's six products
  uint32_t u[3 * RQ2_W], v[3 * RQ2_W], out[RQ12_W];
  uint32_t x[RQ2_W], y[RQ2_W], n[RQ2_W];
  // u = a0^2 - v a1^2
  r6_mul(u, a, a, t);
  r6_mul(v, a + 3 * RQ2_W, a + 3 * RQ2_W, t);
  r2_mul_xi(x, v + 2 * RQ2_W);                // v * (c0, c1, c2) = (XI c2, c0, c1)
  r2_sub(u, u, x);
  r2_sub(u + RQ2_W, u + RQ2_W, v);
  r2_sub(u + 2 * RQ2_W, u + 2 * RQ2_W, v + RQ2_W);
  // fp6_inv(u): c0 = u0^2 - XI u1 u2, c1 = XI u2^2 - u0 u1, c2 = u1^2 - u0 u2
  r2_sqr(v, u);
  r2_mul(x, u + RQ2_W, u + 2 * RQ2_W);
  r2_mul_xi(x, x);
  r2_sub(v, v, x);
  r2_sqr(x, u + 2 * RQ2_W);
  r2_mul_xi(x, x);
  r2_mul(y, u, u + RQ2_W);
  r2_sub(v + RQ2_W, x, y);
  r2_sqr(x, u + RQ2_W);
  r2_mul(y, u, u + 2 * RQ2_W);
  r2_sub(v + 2 * RQ2_W, x, y);
  // norm = u0 c0 + XI (u2 c1 + u1 c2)
  r2_mul(x, u + 2 * RQ2_W, v + RQ2_W);
  r2_mul(y, u + RQ2_W, v + 2 * RQ2_W);
  r2_add(x, x, y);
  r2_mul_xi(x, x);
  r2_mul(n, u, v);
  r2_add(n, n, x);
  r2_inv(n, n);
  // u^-1 = (c0, c1, c2) n^-1
  r2_mul(u, v, n);
  r2_mul(u + RQ2_W, v + RQ2_W, n);
  r2_mul(u + 2 * RQ2_W, v + 2 * RQ2_W, n);
  // r = (a0 u^-1, -(a1 u^-1))
  r6_mul(v, a + 3 * RQ2_W, u, t);
  r6_mul(out, a, u, t);
  r2_neg(out + 3 * RQ2_W, v);
  r2_neg(out + 4 * RQ2_W, v + RQ2_W);
  r2_neg(out + 5 * RQ2_W, v + 2 * RQ2_W);
  if (lane == 0) rq_copy(r, out, RQ12_W);
}

// ---------------------------------------------------------------------------
// the Miller loop's steps for chunk [c, c + CHECK_CHUNK) of the job's pairs.
// g1 [k, 24] (xp, yp), g2 [k, 48] (xq, yq), skip [k], tq [k, 72] (T)
// ---------------------------------------------------------------------------

struct check_job_args {
  const uint32_t* g1;
  const uint32_t* g2;
  const uint8_t* skip;
  uint32_t* tq;
  int64_t k;
};

// an Fq as the Fq2 (s, 0)
BLS_FN void fq_as_fq2(uint32_t* r, const uint32_t* s) {
  rq_copy(r, s, RQ_W);
  rq_set_zero(r + RQ_W, RQ_W);
}

// the pair of slot `slot` of chunk c, or -1 (past the end or skipped)
BLS_FN int64_t chunk_pair(const check_job_args& j, int64_t c, int slot) {
  const int64_t p = c + slot;
  return (slot < CHECK_CHUNK && p < j.k && !j.skip[p]) ? p : -1;
}

// the tangent at T, scaled by w^3 and 2 Y Z^3 (`_double_step`):
// c0 = 3X^3 - 2Y^2, c1 = -3X^2 Z^2 xp, c4 = 2 Y Z^3 yp; then T <- 2T
// The doubling step at Fq granularity: every lane computes one Fq product
// of one pair's step, inline (the levels call nothing).  A square x^2 is
// two products (component 0 (x0 + x1)(x0 - x1), component 1 2 x0 x1), an
// Fq2 times an Fq two (a component each), a full Fq2 product three
// Karatsuba parts kept in `mparts` and rebuilt where they are read.
enum PartKind { PK_SQR, PK_MUL, PK_FQ };
enum MillerParts { MP_YZ, MP_X3, MP_X2Z2, MP_Z3, MP_C4, MP_EDX, MP_COUNT };

// part `part` of the product of kind `kind` of a and b (b an Fq for PK_FQ)
BLS_FN void fq_part(uint32_t* out, int kind, int part, const uint32_t* a,
                    const uint32_t* b) {
  uint32_t u[RQ_W], v[RQ_W];
  if (kind == PK_SQR) {
    if (part == 0) {
      rq_add(u, a, a + RQ_W);
      rq_sub(v, a, a + RQ_W);
    } else {
      rq_copy(u, a, RQ_W);
      rq_copy(v, a + RQ_W, RQ_W);
    }
  } else if (kind == PK_MUL) {
    if (part < 2) {
      rq_copy(u, a + part * RQ_W, RQ_W);
      rq_copy(v, b + part * RQ_W, RQ_W);
    } else {
      rq_add(u, a, a + RQ_W);
      rq_add(v, b, b + RQ_W);
    }
  } else {
    rq_copy(u, a + part * RQ_W, RQ_W);
    rq_copy(v, b, RQ_W);
  }
  rq_mul(out, u, v);
  if (kind == PK_SQR && part == 1) rq_add(out, out, out);
}

// where part `part` of a product goes: a component of an Fq2 slot of
// `tmp` (squares and Fq2 x Fq), or a Karatsuba part of `mparts`
BLS_FN uint32_t* part_dst(check_smem* s, int slot, int kind, int part,
                          int tmp_idx, int mp_idx) {
  return kind == PK_MUL ? s->mparts[slot][mp_idx][part]
                        : s->tmp[slot][tmp_idx] + part * RQ_W;
}

// the Fq2 product of Karatsuba parts `mp_idx` of a slot
BLS_FN void mp_get(uint32_t* out, check_smem* s, int slot, int mp_idx) {
  kara_fq2(out, s->mparts[slot][mp_idx]);
}

// D1, 11 lanes a pair: X^2, Y^2, Z^2 (2 each), Y Z (3), Y yp (2)
BLS_CALL void lvl_dbl1(int lane, check_smem* s, check_job_args j,
                       int64_t c) {
  const int slot = lane / 11, r = lane % 11;
  const int64_t p = chunk_pair(j, c, slot);
  const int64_t q = p < 0 ? 0 : p;
  const uint32_t* T = j.tq + q * RG2_W;
  int kind, part, ti = 0, mi = 0;
  const uint32_t* a;
  const uint32_t* b = nullptr;
  if (r < 6) {
    kind = PK_SQR;
    part = r & 1;
    a = T + (r / 2) * RQ2_W;
    ti = r < 2 ? MT_X2 : (r < 4 ? MT_Y2 : MT_Z2);
  } else if (r < 9) {
    kind = PK_MUL;
    part = r - 6;
    a = RG2_Y(T);
    b = RG2_Z(T);
    mi = MP_YZ;
  } else {
    kind = PK_FQ;
    part = r - 9;
    a = RG2_Y(T);
    b = j.g1 + q * 2 * RQ_W + RQ_W;
    ti = MT_YYP;
  }
  uint32_t w[RQ_W];
  fq_part(w, kind, part, a, b);
  if (p >= 0) rq_copy(part_dst(s, slot, kind, part, ti, mi), w, RQ_W);
}

// D2, 15 lanes a pair: X X^2 (3), C = Y^4 (2), (X + Y^2)^2 (2),
// (3 X^2)^2 (2), X^2 Z^2 (3), Z Z^2 (3)
BLS_CALL void lvl_dbl2(int lane, check_smem* s, check_job_args j,
                       int64_t c) {
  const int slot = lane / 15, r = lane % 15;
  const int64_t p = chunk_pair(j, c, slot);
  const int64_t q = p < 0 ? 0 : p;
  const uint32_t* T = j.tq + q * RG2_W;
  uint32_t(*m)[RQ2_W] = s->tmp[slot < CHECK_CHUNK ? slot : 0];
  uint32_t x[RQ2_W];
  int kind, part, ti = 0, mi = 0;
  const uint32_t* a = x;
  const uint32_t* b = nullptr;
  if (r < 3) {
    kind = PK_MUL; part = r; a = RG2_X(T); b = m[MT_X2]; mi = MP_X3;
  } else if (r < 5) {
    kind = PK_SQR; part = r - 3; a = m[MT_Y2]; ti = MT_C;
  } else if (r < 7) {
    kind = PK_SQR; part = r - 5; ti = MT_T;
    r2_add(x, RG2_X(T), m[MT_Y2]);
  } else if (r < 9) {
    kind = PK_SQR; part = r - 7; ti = MT_FV;
    r2_add(x, m[MT_X2], m[MT_X2]);
    r2_add(x, x, m[MT_X2]);
  } else if (r < 12) {
    kind = PK_MUL; part = r - 9; a = m[MT_X2]; b = m[MT_Z2]; mi = MP_X2Z2;
  } else {
    kind = PK_MUL; part = r - 12; a = RG2_Z(T); b = m[MT_Z2]; mi = MP_Z3;
  }
  uint32_t w[RQ_W];
  fq_part(w, kind, part, a, b);
  if (p >= 0) rq_copy(part_dst(s, slot, kind, part, ti, mi), w, RQ_W);
}

// D3, 8 lanes a pair: (3 X^2 Z^2) xp (2), (Y yp) Z^3 (3), E (D - Xn) (3)
// with E = 3 X^2, D = 2 ((X + Y^2)^2 - X^2 - C), Xn = E^2 - 2D
BLS_CALL void lvl_dbl3(int lane, check_smem* s, check_job_args j,
                       int64_t c) {
  const int slot = lane / 8, r = lane % 8;
  const int64_t p = chunk_pair(j, c, slot);
  const int64_t q = p < 0 ? 0 : p;
  const int sl = slot < CHECK_CHUNK ? slot : 0;
  uint32_t(*m)[RQ2_W] = s->tmp[sl];
  uint32_t x[RQ2_W], y[RQ2_W];
  int kind, part, ti = 0, mi = 0;
  const uint32_t* a = x;
  const uint32_t* b = y;
  if (r < 2) {
    kind = PK_FQ; part = r; ti = MT_C1;
    mp_get(x, s, sl, MP_X2Z2);
    r2_add(y, x, x);
    r2_add(x, y, x);
    b = j.g1 + q * 2 * RQ_W;
  } else if (r < 5) {
    kind = PK_MUL; part = r - 2; mi = MP_C4;
    a = m[MT_YYP];
    mp_get(y, s, sl, MP_Z3);
  } else {
    kind = PK_MUL; part = r - 5; mi = MP_EDX;
    uint32_t D[RQ2_W];
    r2_sub(D, m[MT_T], m[MT_X2]);
    r2_sub(D, D, m[MT_C]);
    r2_add(D, D, D);
    r2_add(y, D, D);
    r2_sub(y, m[MT_FV], y);            // Xn
    r2_sub(y, D, y);                   // D - Xn
    r2_add(x, m[MT_X2], m[MT_X2]);
    r2_add(x, x, m[MT_X2]);            // E
  }
  uint32_t w[RQ_W];
  fq_part(w, kind, part, a, b);
  if (p >= 0) rq_copy(part_dst(s, slot, kind, part, ti, mi), w, RQ_W);
}

// D4, 6 lanes a pair: the line (c0 = 3X^3 - 2Y^2, c1 = -3X^2 Z^2 xp,
// c4 = 2 Y Z^3 yp) and T <- 2T (Xn = E^2 - 2D, Yn = E (D - Xn) - 8C,
// Zn = 2 Y Z); additions only
BLS_CALL void lvl_dbl4(int lane, check_smem* s, check_job_args j,
                       int64_t c) {
  const int slot = lane / 6, o = lane % 6;
  const int64_t p = chunk_pair(j, c, slot);
  if (p < 0) return;
  uint32_t* T = j.tq + p * RG2_W;
  uint32_t(*m)[RQ2_W] = s->tmp[slot];
  uint32_t* l = s->line[slot];
  uint32_t x[RQ2_W], y[RQ2_W];
  if (o == 0) {
    mp_get(x, s, slot, MP_X3);
    r2_add(y, x, x);
    r2_add(x, y, x);
    r2_add(y, m[MT_Y2], m[MT_Y2]);
    r2_sub(FQ12_C(l, 0), x, y);
  } else if (o == 1) {
    r2_neg(FQ12_C(l, 1), m[MT_C1]);
  } else if (o == 2) {
    mp_get(x, s, slot, MP_C4);
    r2_add(FQ12_C(l, 4), x, x);
  } else if (o == 3) {
    r2_sub(x, m[MT_T], m[MT_X2]);
    r2_sub(x, x, m[MT_C]);
    r2_add(x, x, x);                   // D
    r2_add(x, x, x);
    r2_sub(RG2_X(T), m[MT_FV], x);
  } else if (o == 4) {
    mp_get(x, s, slot, MP_EDX);
    r2_add(y, m[MT_C], m[MT_C]);
    r2_add(y, y, y);
    r2_add(y, y, y);
    r2_sub(RG2_Y(T), x, y);
  } else {
    mp_get(x, s, slot, MP_YZ);
    r2_add(RG2_Z(T), x, x);
  }
}

// the line through T and the affine Q = (x2, y2) at P, scaled by Z1 lam
// (`_add_step`): theta = Y1 - y2 Z1^3, lam = X1 - x2 Z1^2, c0 = theta x2 -
// y2 Z1 lam, c1 = -theta xp, c4 = Z1 lam yp; then T <- T + Q
// (madd-2007-bl)
BLS_CALL void lvl_add1(int lane, check_smem* s, check_job_args j,
                       int64_t c) {
  const int slot = lane / 2, i = lane % 2;
  const int64_t p = chunk_pair(j, c, slot);
  uint32_t x[RQ2_W] = {0}, v[RQ2_W];
  const uint32_t* a = x;
  const uint32_t* b = x;
  if (p >= 0) {
    const uint32_t* T = j.tq + p * RG2_W;
    a = i == 0 ? RG2_Z(T) : j.g2 + p * 2 * RQ2_W + RQ2_W;   // Z1^2, y2 Z1
    b = RG2_Z(T);
  }
  r2_mul(v, a, b);
  if (p >= 0) rq_copy(s->tmp[slot][i == 0 ? MA_ZZ : MA_YZ1], v, RQ2_W);
}

BLS_CALL void lvl_add2(int lane, check_smem* s, check_job_args j,
                       int64_t c) {
  const int slot = lane / 2, i = lane % 2;
  const int64_t p = chunk_pair(j, c, slot);
  uint32_t x[RQ2_W] = {0}, v[RQ2_W];
  const uint32_t* a = x;
  const uint32_t* b = x;
  uint32_t(*m)[RQ2_W] = s->tmp[slot < CHECK_CHUNK ? slot : 0];
  if (p >= 0) {
    a = i == 0 ? j.g2 + p * 2 * RQ2_W : m[MA_YZ1];   // U2 = x2 Z1^2, S2
    b = m[MA_ZZ];
  }
  r2_mul(v, a, b);
  if (p >= 0) rq_copy(m[i == 0 ? MA_U2 : MA_S2], v, RQ2_W);
}

// theta = Y1 - S2, lam = X1 - U2
BLS_FN void add_theta_lam(const uint32_t* T, uint32_t (*m)[RQ2_W],
                          uint32_t* theta, uint32_t* lam) {
  r2_sub(theta, RG2_Y(T), m[MA_S2]);
  r2_sub(lam, RG2_X(T), m[MA_U2]);
}

BLS_CALL void lvl_add3(int lane, check_smem* s, check_job_args j,
                       int64_t c) {
  const int slot = lane / 5, i = lane % 5;
  const int64_t p = chunk_pair(j, c, slot);
  uint32_t theta[RQ2_W] = {0}, lam[RQ2_W] = {0}, x[RQ2_W] = {0}, v[RQ2_W];
  const uint32_t* a = x;
  const uint32_t* b = x;
  uint32_t(*m)[RQ2_W] = s->tmp[slot < CHECK_CHUNK ? slot : 0];
  if (p >= 0) {
    const uint32_t* T = j.tq + p * RG2_W;
    add_theta_lam(T, m, theta, lam);
    if (i == 0) { a = RG2_Z(T); b = lam; }             // Z1 lam
    else if (i == 1) { a = theta; b = j.g2 + p * 2 * RQ2_W; }  // theta x2
    else if (i == 2) {                                 // theta xp
      a = theta;
      fq_as_fq2(x, j.g1 + p * 2 * RQ_W);
    } else if (i == 3) a = b = lam;                    // H^2 = lam^2
    else {                                             // r^2 = (2 theta)^2
      r2_add(x, theta, theta);
    }
  }
  r2_mul(v, a, b);
  if (p < 0) return;
  if (i == 2) r2_neg(FQ12_C(s->line[slot], 1), v);    // c1 = -theta xp
  else {
    const int dst[5] = {MA_ZL, MA_TX, 0, MA_HH, MA_R2};
    rq_copy(m[dst[i]], v, RQ2_W);
  }
}

BLS_CALL void lvl_add4(int lane, check_smem* s, check_job_args j,
                       int64_t c) {
  const int slot = lane / 4, i = lane % 4;
  const int64_t p = chunk_pair(j, c, slot);
  uint32_t I[RQ2_W] = {0}, x[RQ2_W] = {0}, v[RQ2_W];
  const uint32_t* a = x;
  const uint32_t* b = x;
  uint32_t(*m)[RQ2_W] = s->tmp[slot < CHECK_CHUNK ? slot : 0];
  if (p >= 0) {
    const uint32_t* T = j.tq + p * RG2_W;
    r2_add(I, m[MA_HH], m[MA_HH]);
    r2_add(I, I, I);                   // I = 4 H^2
    if (i == 0) { a = j.g2 + p * 2 * RQ2_W + RQ2_W; b = m[MA_ZL]; }  // y2 Z1 lam
    else if (i == 1) {                 // c4 = Z1 lam yp
      a = m[MA_ZL];
      fq_as_fq2(x, j.g1 + p * 2 * RQ_W + RQ_W);
    } else if (i == 2) {               // J = H I, H = -lam
      uint32_t theta[RQ2_W];
      add_theta_lam(T, m, theta, x);
      r2_neg(x, x);
      b = I;
    } else {                           // V = X1 I
      a = RG2_X(T);
      b = I;
    }
  }
  r2_mul(v, a, b);
  if (p < 0) return;
  if (i == 0) r2_sub(FQ12_C(s->line[slot], 0), m[MA_TX], v);  // c0
  else if (i == 1) rq_copy(FQ12_C(s->line[slot], 4), v, RQ2_W);
  else rq_copy(m[i == 2 ? MA_J : MA_V], v, RQ2_W);
}

BLS_CALL void lvl_add5(int lane, check_smem* s, check_job_args j,
                       int64_t c) {
  const int slot = lane / 2, i = lane % 2;
  const int64_t p = chunk_pair(j, c, slot);
  uint32_t x[RQ2_W] = {0}, y[RQ2_W] = {0}, Xn[RQ2_W], v[RQ2_W];
  const uint32_t* a = x;
  const uint32_t* b = y;
  uint32_t(*m)[RQ2_W] = s->tmp[slot < CHECK_CHUNK ? slot : 0];
  if (p >= 0) {
    const uint32_t* T = j.tq + p * RG2_W;
    if (i == 0) {                      // r (V - Xn), Xn = r^2 - J - 2V
      uint32_t lam[RQ2_W];
      r2_sub(Xn, m[MA_R2], m[MA_J]);
      r2_sub(Xn, Xn, m[MA_V]);
      r2_sub(Xn, Xn, m[MA_V]);
      add_theta_lam(T, m, x, lam);
      r2_add(x, x, x);
      r2_neg(x, x);                    // r = -2 theta
      r2_sub(y, m[MA_V], Xn);
    } else {                           // Y1 J
      a = RG2_Y(T);
      b = m[MA_J];
    }
  }
  r2_mul(v, a, b);
  if (p < 0) return;
  if (i == 0) {
    rq_copy(m[MA_XN], Xn, RQ2_W);
    rq_copy(m[MA_RV], v, RQ2_W);
  } else {
    rq_copy(m[MA_YJ], v, RQ2_W);
  }
}

BLS_CALL void lvl_add6(int lane, check_smem* s, check_job_args j,
                       int64_t c) {
  const int slot = lane;
  const int64_t p = chunk_pair(j, c, slot);
  if (p < 0) return;
  uint32_t* T = j.tq + p * RG2_W;
  uint32_t(*m)[RQ2_W] = s->tmp[slot];
  uint32_t x[RQ2_W];
  r2_add(x, m[MA_YJ], m[MA_YJ]);
  r2_sub(RG2_Y(T), m[MA_RV], x);       // Yn = r (V - Xn) - 2 Y1 J
  r2_add(x, m[MA_ZL], m[MA_ZL]);
  r2_neg(RG2_Z(T), x);                 // Zn = 2 Z1 H = -2 Z1 lam
  rq_copy(RG2_X(T), m[MA_XN], RQ2_W);
}

// f = 1, the chunk's lines zero (their unused coefficients stay zero), and
// T_i = (xq, yq, 1) for every pair
BLS_CALL void lvl_init(int lane, check_smem* s, check_job_args j) {
  if (lane < 12) {
    if (lane == 0) rq_set_one(s->w[CS_F]);
    else rq_set_zero(s->w[CS_F] + lane * RQ_W, RQ_W);
  }
  for (int i = lane; i < CHECK_CHUNK * 12; i += CHECK_LANES)
    rq_set_zero(s->line[i / 12] + (i % 12) * RQ_W, RQ_W);
  for (int64_t p = lane; p < j.k; p += CHECK_LANES) {
    uint32_t* T = j.tq + p * RG2_W;
    rq_copy(T, j.g2 + p * 2 * RQ2_W, 2 * RQ2_W);
    rq_set_one(RG2_Z(T));
    rq_set_zero(RG2_Z(T) + RQ_W, RQ_W);
  }
}

// lanes 0..11 write the product; lane 0 then the verdict
BLS_CALL void lvl_store(int lane, const uint32_t* f, uint32_t* out) {
  if (lane < 12) rq_copy(out + lane * RQ_W, f + lane * RQ_W, RQ_W);
}

BLS_CALL void lvl_is_one(int lane, const uint32_t* f, uint8_t* ok) {
  if (lane != 0) return;
  uint32_t acc = 0;
  for (int i = 0; i < RQ12_W; ++i)
    acc |= f[i] ^ (i < RQ_W ? BLS_ONE[i] : 0u);
  *ok = acc == 0 ? 1 : 0;
}

// ---------------------------------------------------------------------------
// the job: Miller loop, product, final exponentiation, verdict
// ---------------------------------------------------------------------------

BLS_CALL void w_mul(check_smem* s, uint32_t* r, const uint32_t* a,
                    const uint32_t* b) {
  BLS_LEVEL(lvl_mul_products(lane, &s->mul, a, b));
  BLS_LEVEL(lvl_mul_sums(lane, &s->mul));
  BLS_LEVEL(lvl_mul_out(lane, &s->mul, r));
}

BLS_CALL void w_cyc(check_smem* s, uint32_t* r, const uint32_t* a) {
  BLS_LEVEL(lvl_cyc_products(lane, s->cyc, a));
  BLS_LEVEL(lvl_cyc_out(lane, s->cyc, a, r));
}

// r = m^x (x < 0): cyclotomic square-and-multiply by |x|, then conjugate;
// r must not alias m
BLS_CALL void w_exp_by_neg_x(check_smem* s, uint32_t* r, const uint32_t* m) {
  BLS_LEVEL(lvl_conj(lane, r, m, false));
  for (int i = 62; i >= 0; --i) {
    w_cyc(s, r, r);
    if ((BLS_X_ABS >> i) & 1ull) w_mul(s, r, r, m);
  }
  BLS_LEVEL(lvl_conj(lane, r, r, true));
}

// f^2 on warps 0-1 (lanes 0..63) beside the doubling steps of chunk 0 on
// warps 2-3 (lanes 64..127): each warp runs one of the two bodies, so no
// warp diverges across the calls
BLS_CALL void lvl_sqr1_dbl1(int lane, check_smem* s, const uint32_t* f,
                            check_job_args j) {
  if (lane < CHECK_HALF) lvl_mul_products(lane, &s->mul, f, f);
  else lvl_dbl1(lane - CHECK_HALF, s, j, 0);
}

BLS_CALL void lvl_sqr2_dbl2(int lane, check_smem* s, check_job_args j) {
  if (lane < CHECK_HALF) lvl_mul_sums(lane, &s->mul);
  else lvl_dbl2(lane - CHECK_HALF, s, j, 0);
}

BLS_CALL void lvl_sqr3_dbl3(int lane, check_smem* s, uint32_t* f,
                            check_job_args j) {
  if (lane < CHECK_HALF) lvl_mul_out(lane, &s->mul, f);
  else lvl_dbl3(lane - CHECK_HALF, s, j, 0);
}

// multiply f by the lines of the chunk's live pairs
BLS_FN void w_mul_lines(check_smem* s, const check_job_args& j, int64_t c) {
  for (int slot = 0; slot < CHECK_CHUNK; ++slot)
    if (chunk_pair(j, c, slot) >= 0)
      w_mul(s, s->w[CS_F], s->w[CS_F], s->line[slot]);
}

// The Miller loop of the job's pairs into s->w[CS_F]: the product of
// their Miller values, conjugated (x < 0).  Every lane of the block calls
// it; its control flow is uniform across the block.
BLS_FN void check_miller(check_smem* s, check_job_args j) {
  uint32_t* f = s->w[CS_F];
  BLS_LEVEL(lvl_init(lane, s, j));
  for (int i = 62; i >= 0; --i) {
    BLS_LEVEL(lvl_sqr1_dbl1(lane, s, f, j));
    BLS_LEVEL(lvl_sqr2_dbl2(lane, s, j));
    BLS_LEVEL(lvl_sqr3_dbl3(lane, s, f, j));
    BLS_LEVEL(lvl_dbl4(lane, s, j, 0));
    w_mul_lines(s, j, 0);
    for (int64_t c = CHECK_CHUNK; c < j.k; c += CHECK_CHUNK) {
      BLS_LEVEL(lvl_dbl1(lane, s, j, c));
      BLS_LEVEL(lvl_dbl2(lane, s, j, c));
      BLS_LEVEL(lvl_dbl3(lane, s, j, c));
      BLS_LEVEL(lvl_dbl4(lane, s, j, c));
      w_mul_lines(s, j, c);
    }
    if ((BLS_X_ABS >> i) & 1ull) {
      for (int64_t c = 0; c < j.k; c += CHECK_CHUNK) {
        BLS_LEVEL(lvl_add1(lane, s, j, c));
        BLS_LEVEL(lvl_add2(lane, s, j, c));
        BLS_LEVEL(lvl_add3(lane, s, j, c));
        BLS_LEVEL(lvl_add4(lane, s, j, c));
        BLS_LEVEL(lvl_add5(lane, s, j, c));
        BLS_LEVEL(lvl_add6(lane, s, j, c));
        w_mul_lines(s, j, c);
      }
    }
  }
  BLS_LEVEL(lvl_conj(lane, f, f, true));
}

// The final exponentiation of s->w[CS_F] (which it keeps) and the verdict:
// ok = 1 when the value is one, else 0.  Block-uniform like check_miller.
BLS_FN void check_final(check_smem* s, uint8_t* ok) {
  uint32_t(*w)[RQ12_W] = s->w;
  const uint32_t* f = w[CS_F];
  // the easy part: m = f1^(q^2) f1, f1 = conj(f) f^-1
  BLS_LEVEL(lvl_inv(lane, w[CS_T1], f));
  BLS_LEVEL(lvl_conj(lane, w[CS_T0], f, true));
  w_mul(s, w[CS_T3], w[CS_T0], w[CS_T1]);
  BLS_LEVEL(lvl_frob(lane, w[CS_T0], w[CS_T3], 2));
  w_mul(s, w[CS_T2], w[CS_T0], w[CS_T3]);
  // the hard part, `_hard_chain`'s order (t2 = m)
  w_cyc(s, w[CS_T1], w[CS_T2]);
  BLS_LEVEL(lvl_conj(lane, w[CS_T1], w[CS_T1], true));   // t1 = m^-2
  w_exp_by_neg_x(s, w[CS_T3], w[CS_T2]);                 // t3 = m^x
  w_cyc(s, w[CS_T4], w[CS_T3]);                          // t4 = m^2x
  w_mul(s, w[CS_T5], w[CS_T1], w[CS_T3]);                // t5 = m^(x-2)
  w_exp_by_neg_x(s, w[CS_T1], w[CS_T5]);
  w_exp_by_neg_x(s, w[CS_T0], w[CS_T1]);
  w_exp_by_neg_x(s, w[CS_T6], w[CS_T0]);
  w_mul(s, w[CS_T6], w[CS_T6], w[CS_T4]);
  w_exp_by_neg_x(s, w[CS_T4], w[CS_T6]);
  BLS_LEVEL(lvl_conj(lane, w[CS_T5], w[CS_T5], true));
  w_mul(s, w[CS_T4], w[CS_T4], w[CS_T5]);
  w_mul(s, w[CS_T4], w[CS_T4], w[CS_T2]);
  BLS_LEVEL(lvl_conj(lane, w[CS_T5], w[CS_T2], true));
  w_mul(s, w[CS_T1], w[CS_T1], w[CS_T2]);
  BLS_LEVEL(lvl_frob(lane, w[CS_T1], w[CS_T1], 3));
  w_mul(s, w[CS_T6], w[CS_T6], w[CS_T5]);
  BLS_LEVEL(lvl_frob(lane, w[CS_T6], w[CS_T6], 1));
  w_mul(s, w[CS_T3], w[CS_T3], w[CS_T0]);
  BLS_LEVEL(lvl_frob(lane, w[CS_T3], w[CS_T3], 2));
  w_mul(s, w[CS_T3], w[CS_T3], w[CS_T1]);
  w_mul(s, w[CS_T3], w[CS_T3], w[CS_T6]);
  w_mul(s, w[CS_T3], w[CS_T3], w[CS_T4]);
  BLS_LEVEL(lvl_is_one(lane, w[CS_T3], ok));
}

// One job: writes the product of its Miller values (conjugated, before the
// final exponentiation) to prod (144 words) and the verdict to ok.
BLS_FN void check_job(check_smem* s, check_job_args j, uint32_t* prod,
                      uint8_t* ok) {
  check_miller(s, j);
  BLS_LEVEL(lvl_store(lane, s->w[CS_F], prod));
  check_final(s, ok);
}
