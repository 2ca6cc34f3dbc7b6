// Register-resident BLS12-381 arithmetic for the redesigned kernels
// (bls381_cofactor.cu, bls381_check.cu): the Montgomery product with its
// operands and accumulator in registers, pointer-based Fq and Fq2 ops, G2
// Jacobian points, the psi endomorphism and G2 cofactor clearing.
//
// bls381.cuh's first design passes structs by reference to out-of-line
// functions, so every Fq product of the older kernels reads and writes its
// operands through the thread's stack.  Here the product is inlined into
// each caller: its 12-word operands and 13-word accumulator are registers,
// and on the card each CIOS row is two PTX carry chains (mad.lo.cc.u32 /
// madc.lo.cc.u32, then mad.hi.cc.u32 / madc.hi.cc.u32), one asm statement
// a chain, so the carry flag never leaves a chain.  The Fq2 ops are out of
// line and take pointers (a point's coordinates, a job's shared memory), so
// no struct passes through the stack; what a stack remains holds a
// thread's points, not spilled registers.
//
// No out-of-line function is called from code that diverges across a warp:
// the point add selects its case instead of branching, and the warp check's
// levels (bls381_check.cuh) make the same calls on every lane.  Builds that
// did faulted on the card (an illegal address) although they equalled
// their host builds; the cause is not known.  One hypothesis, from the
// SASS: ptxas passes an out-of-line function's pointer arguments in the
// warp's uniform registers when every call site looks uniform, and two
// divergent groups of a warp inside such functions at once then read each
// other's pointers.
//
// Why no tensor cores or TMA: each result is a chain of dependent 381-bit
// products with carries over about 600 bytes of state.  No wgmma tile fits
// a 12 x 12-word product with carry propagation, and there is nothing to
// stream.  What bounds these kernels is the 32-bit integer multiply rate,
// registers, a warp's lanes and shared memory.
//
// The same source compiles as host C++ (no __CUDACC__): the product is then
// the portable CIOS body, so the device functions are held against the
// plain torch versions without a card.
#pragma once

#include "bls381.cuh"

#define RQ_W 12              // words of an Fq element
#define RQ2_W 24             // of an Fq2 element
#define RG2_W 72             // of a Jacobian G2 point (X, Y, Z)

#if defined(__CUDACC__)
// t[0..12] += x[0..11] * s: the low halves in one carry chain, then the
// high halves one word up in another (operands: %0..%12 t, %13..%24 x,
// %25 s).  The high chain's carry out is zero: t < 2q + q * 2^32 < 2^416.
#define RQ_LO_CHAIN                                                        \
  "mad.lo.cc.u32 %0, %13, %25, %0;\n\t"                                    \
  "madc.lo.cc.u32 %1, %14, %25, %1;\n\t"                                   \
  "madc.lo.cc.u32 %2, %15, %25, %2;\n\t"                                   \
  "madc.lo.cc.u32 %3, %16, %25, %3;\n\t"                                   \
  "madc.lo.cc.u32 %4, %17, %25, %4;\n\t"                                   \
  "madc.lo.cc.u32 %5, %18, %25, %5;\n\t"                                   \
  "madc.lo.cc.u32 %6, %19, %25, %6;\n\t"                                   \
  "madc.lo.cc.u32 %7, %20, %25, %7;\n\t"                                   \
  "madc.lo.cc.u32 %8, %21, %25, %8;\n\t"                                   \
  "madc.lo.cc.u32 %9, %22, %25, %9;\n\t"                                   \
  "madc.lo.cc.u32 %10, %23, %25, %10;\n\t"                                 \
  "madc.lo.cc.u32 %11, %24, %25, %11;\n\t"                                 \
  "addc.u32 %12, %12, 0;"
#define RQ_HI_CHAIN                                                        \
  "mad.hi.cc.u32 %1, %13, %25, %1;\n\t"                                    \
  "madc.hi.cc.u32 %2, %14, %25, %2;\n\t"                                   \
  "madc.hi.cc.u32 %3, %15, %25, %3;\n\t"                                   \
  "madc.hi.cc.u32 %4, %16, %25, %4;\n\t"                                   \
  "madc.hi.cc.u32 %5, %17, %25, %5;\n\t"                                   \
  "madc.hi.cc.u32 %6, %18, %25, %6;\n\t"                                   \
  "madc.hi.cc.u32 %7, %19, %25, %7;\n\t"                                   \
  "madc.hi.cc.u32 %8, %20, %25, %8;\n\t"                                   \
  "madc.hi.cc.u32 %9, %21, %25, %9;\n\t"                                   \
  "madc.hi.cc.u32 %10, %22, %25, %10;\n\t"                                 \
  "madc.hi.cc.u32 %11, %23, %25, %11;\n\t"                                 \
  "madc.hi.u32 %12, %24, %25, %12;"
#define RQ_CHAIN_OPERANDS(t, x, s)                                         \
  : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),           \
    "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),           \
    "+r"(t[10]), "+r"(t[11]), "+r"(t[12])                                  \
  : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]),     \
    "r"(x[6]), "r"(x[7]), "r"(x[8]), "r"(x[9]), "r"(x[10]), "r"(x[11]),   \
    "r"(s)

BLS_FN void rq_row(uint32_t* t, const uint32_t* x, uint32_t s) {
  asm(RQ_LO_CHAIN RQ_CHAIN_OPERANDS(t, x, s));
  asm(RQ_HI_CHAIN RQ_CHAIN_OPERANDS(t, x, s));
}
#else
BLS_FN void rq_row(uint32_t* t, const uint32_t* x, uint32_t s) {
  uint64_t c = 0;
  for (int j = 0; j < RQ_W; ++j) {
    c += (uint64_t)x[j] * s + t[j];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  t[RQ_W] += (uint32_t)c;
}
#endif

// r = a * b * 2^-384 mod q (CIOS), canonical for canonical inputs; r may
// alias a or b.  Inlined into every caller: a 12-word row per word of b,
// each followed by the reduction row m * q and a one-word shift, which is
// register renaming once the loop unrolls.
BLS_FN void rq_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t x[RQ_W], y[RQ_W], q[RQ_W], t[RQ_W + 1];
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) {
    x[i] = a[i];
    y[i] = b[i];
    q[i] = BLS_Q[i];
    t[i] = 0;
  }
  t[RQ_W] = 0;
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) {
    rq_row(t, x, y[i]);
    rq_row(t, q, t[0] * BLS_QINV);      // t[0] becomes zero
#pragma unroll
    for (int j = 0; j < RQ_W; ++j) t[j] = t[j + 1];
    t[RQ_W] = 0;
  }
  // t < 2q: one conditional subtract
  uint32_t d[RQ_W], borrow = 0;
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) {
    const uint64_t v = (uint64_t)t[i] - q[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) r[i] = borrow ? t[i] : d[i];
}

// (a + b) mod q; r may alias a or b
BLS_FN void rq_add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t s[RQ_W], d[RQ_W], borrow = 0;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) {
    c += (uint64_t)a[i] + b[i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) {
    const uint64_t v = (uint64_t)s[i] - BLS_Q[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) r[i] = borrow ? s[i] : d[i];
}

// (a - b) mod q; r may alias a or b
BLS_FN void rq_sub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t d[RQ_W], borrow = 0;
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) {
    const uint64_t v = (uint64_t)a[i] - b[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  const uint32_t mask = 0u - borrow;     // add q back where it borrowed
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) {
    c += (uint64_t)d[i] + (BLS_Q[i] & mask);
    r[i] = (uint32_t)c;
    c >>= 32;
  }
}

BLS_FN bool rq_is_zero(const uint32_t* a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) acc |= a[i];
  return acc == 0;
}

BLS_FN void rq_neg(uint32_t* r, const uint32_t* a) {
  const uint32_t zero[RQ_W] = {0};
  rq_sub(r, zero, a);
}

BLS_FN void rq_copy(uint32_t* r, const uint32_t* a, int words) {
  for (int i = 0; i < words; ++i) r[i] = a[i];
}

BLS_FN void rq_set_one(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) r[i] = BLS_ONE[i];
}

BLS_FN void rq_set_zero(uint32_t* r, int words) {
  for (int i = 0; i < words; ++i) r[i] = 0;
}

// R^3 mod q: a Montgomery product with it turns (aR)^-1 into a^-1 R
BLS_CONST uint32_t RQ_R3[RQ_W] = {
    0xd94ca1e0u, 0xed48ac6bu, 0x03a7adf8u, 0x315f831eu, 0x615e29ddu,
    0x9a53352au, 0x921e1761u, 0x34c04e5eu, 0x65724728u, 0x2512d435u,
    0x91755d4du, 0x0aa63460u};

BLS_FN bool rq_is_one_int(const uint32_t* a) {
  uint32_t acc = a[0] ^ 1u;
#pragma unroll
  for (int i = 1; i < RQ_W; ++i) acc |= a[i];
  return acc == 0;
}

// a >> 1 over 12 words, with `top` shifted in as bit 383
BLS_FN void rq_half(uint32_t* a, uint32_t top) {
#pragma unroll
  for (int i = 0; i < RQ_W - 1; ++i) a[i] = (a[i] >> 1) | (a[i + 1] << 31);
  a[RQ_W - 1] = (a[RQ_W - 1] >> 1) | (top << 31);
}

// x / 2 mod q for x < q: x even halves, x odd halves x + q (< 2^382)
BLS_FN void rq_half_mod(uint32_t* x) {
  const uint32_t mask = 0u - (x[0] & 1u);
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) {
    c += (uint64_t)x[i] + (BLS_Q[i] & mask);
    x[i] = (uint32_t)c;
    c >>= 32;
  }
  rq_half(x, (uint32_t)c);
}

// a >= b over 12 words
BLS_FN bool rq_geq(const uint32_t* a, const uint32_t* b) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) {
    const uint64_t v = (uint64_t)a[i] - b[i] - borrow;
    borrow = (uint32_t)(v >> 63);
  }
  return borrow == 0;
}

// a - b over 12 words, a >= b
BLS_FN void rq_sub_int(uint32_t* a, const uint32_t* b) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) {
    const uint64_t v = (uint64_t)a[i] - b[i] - borrow;
    a[i] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
}

// Montgomery inverse, a R -> a^-1 R (0 -> 0), by the binary extended
// Euclidean algorithm on the integer aR, then one product by R^3: about 760
// shift and subtract steps of 12 words on the ALU pipe where Fermat's
// a^(q-2) took about 570 dependent products on the multiply pipe.  Its
// loops branch on the data but call nothing.
BLS_CALL void rq_inv(uint32_t* r, const uint32_t* a) {
  uint32_t u[RQ_W], v[RQ_W], x1[RQ_W], x2[RQ_W];
  bool zero = true;
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) {
    u[i] = a[i];
    v[i] = BLS_Q[i];
    x1[i] = 0;
    x2[i] = 0;
    zero = zero && a[i] == 0;
  }
  x1[0] = zero ? 0u : 1u;
  // x1 a = u and x2 a = v (mod q), and gcd(u, v) = 1, down to u or v = 1
  while (!zero && !rq_is_one_int(u) && !rq_is_one_int(v)) {
    while ((u[0] & 1u) == 0) {
      rq_half(u, 0);
      rq_half_mod(x1);
    }
    while ((v[0] & 1u) == 0) {
      rq_half(v, 0);
      rq_half_mod(x2);
    }
    if (rq_geq(u, v)) {
      rq_sub_int(u, v);
      rq_sub(x1, x1, x2);
    } else {
      rq_sub_int(v, u);
      rq_sub(x2, x2, x1);
    }
  }
  const uint32_t pick = rq_is_one_int(u) ? 0u : ~0u;   // x1 unless v is 1
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) x1[i] = (x1[i] & ~pick) | (x2[i] & pick);
  rq_mul(r, x1, RQ_R3);
}

// ---------------------------------------------------------------------------
// Fq2 = Fq[u] / (u^2 + 1) on pointers to 24 words (c0, c1); r may alias
// ---------------------------------------------------------------------------

BLS_FN void r2_add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  rq_add(r, a, b);
  rq_add(r + RQ_W, a + RQ_W, b + RQ_W);
}

BLS_FN void r2_sub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  rq_sub(r, a, b);
  rq_sub(r + RQ_W, a + RQ_W, b + RQ_W);
}

BLS_FN void r2_neg(uint32_t* r, const uint32_t* a) {
  rq_neg(r, a);
  rq_neg(r + RQ_W, a + RQ_W);
}

BLS_FN void r2_conj(uint32_t* r, const uint32_t* a) {
  rq_copy(r, a, RQ_W);
  rq_neg(r + RQ_W, a + RQ_W);
}

BLS_FN bool r2_is_zero(const uint32_t* a) {
  return rq_is_zero(a) && rq_is_zero(a + RQ_W);
}

// times XI = 1 + u: (a0 - a1, a0 + a1)
BLS_FN void r2_mul_xi(uint32_t* r, const uint32_t* a) {
  uint32_t t[RQ_W];
  rq_sub(t, a, a + RQ_W);
  rq_add(r + RQ_W, a, a + RQ_W);
  rq_copy(r, t, RQ_W);
}

// Karatsuba: 3 Fq products
BLS_CALL void r2_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t v0[RQ_W], v1[RQ_W], sa[RQ_W], sb[RQ_W];
  rq_mul(v0, a, b);
  rq_mul(v1, a + RQ_W, b + RQ_W);
  rq_add(sa, a, a + RQ_W);
  rq_add(sb, b, b + RQ_W);
  rq_mul(sa, sa, sb);
  rq_sub(r, v0, v1);
  rq_add(v0, v0, v1);
  rq_sub(r + RQ_W, sa, v0);
}

// (a0 + a1)(a0 - a1), 2 a0 a1: 2 Fq products
BLS_CALL void r2_sqr(uint32_t* r, const uint32_t* a) {
  uint32_t t[RQ_W], s[RQ_W], d[RQ_W];
  rq_mul(t, a, a + RQ_W);
  rq_add(s, a, a + RQ_W);
  rq_sub(d, a, a + RQ_W);
  rq_mul(r, s, d);
  rq_add(r + RQ_W, t, t);
}

// (a0 - a1 u) / (a0^2 + a1^2)
BLS_CALL void r2_inv(uint32_t* r, const uint32_t* a) {
  uint32_t n[RQ_W], t[RQ_W];
  rq_mul(n, a, a);
  rq_mul(t, a + RQ_W, a + RQ_W);
  rq_add(n, n, t);
  rq_inv(n, n);
  rq_neg(t, a + RQ_W);
  rq_mul(r, a, n);
  rq_mul(r + RQ_W, t, n);
}

// ---------------------------------------------------------------------------
// Jacobian G2 points on pointers to 72 words (X, Y, Z); infinity is Z = 0
// ---------------------------------------------------------------------------

#define RG2_X(p) (p)
#define RG2_Y(p) ((p) + RQ2_W)
#define RG2_Z(p) ((p) + 2 * RQ2_W)

// dbl-2009-l (a = 0): A = X^2, B = Y^2, C = B^2, D = 2((X + B)^2 - A - C),
// E = 3A, X3 = E^2 - 2D, Y3 = E(D - X3) - 8C, Z3 = 2YZ; r may alias p
BLS_CALL void rg2_dbl(uint32_t* r, const uint32_t* p) {
  uint32_t A[RQ2_W], B[RQ2_W], C[RQ2_W], D[RQ2_W], E[RQ2_W], F[RQ2_W];
  r2_sqr(A, RG2_X(p));
  r2_sqr(B, RG2_Y(p));
  r2_sqr(C, B);
  r2_add(D, RG2_X(p), B);
  r2_sqr(D, D);
  r2_sub(D, D, A);
  r2_sub(D, D, C);
  r2_add(D, D, D);
  r2_add(E, A, A);
  r2_add(E, E, A);
  r2_sqr(F, E);
  r2_mul(RG2_Z(r), RG2_Y(p), RG2_Z(p));
  r2_add(RG2_Z(r), RG2_Z(r), RG2_Z(r));
  r2_add(A, D, D);
  r2_sub(RG2_X(r), F, A);
  r2_sub(D, D, RG2_X(r));
  r2_mul(D, E, D);
  r2_add(C, C, C);
  r2_add(C, C, C);
  r2_add(C, C, C);
  r2_sub(RG2_Y(r), D, C);
}

// add-2007-bl with the reference's selects: infinity on either side gives
// the other input, equal inputs double, opposite inputs give infinity; r
// may alias p1 or p2.  Branch-free: the general sum and the doubling are
// always computed and the case picks words, so every thread of a warp
// makes the same calls (a first form that branched faulted on the card
// when a warp mixed ordinary rows with infinite or order-169 ones).
BLS_CALL void rg2_add(uint32_t* r, const uint32_t* p1, const uint32_t* p2) {
  uint32_t Z1Z1[RQ2_W], Z2Z2[RQ2_W], U1[RQ2_W], U2[RQ2_W], S1[RQ2_W],
      S2[RQ2_W], H[RQ2_W], rr[RQ2_W], I[RQ2_W], J[RQ2_W], V[RQ2_W],
      o[RG2_W], d[RG2_W];
  r2_sqr(Z1Z1, RG2_Z(p1));
  r2_sqr(Z2Z2, RG2_Z(p2));
  r2_mul(U1, RG2_X(p1), Z2Z2);
  r2_mul(U2, RG2_X(p2), Z1Z1);
  r2_mul(S1, RG2_Y(p1), RG2_Z(p2));
  r2_mul(S1, S1, Z2Z2);
  r2_mul(S2, RG2_Y(p2), RG2_Z(p1));
  r2_mul(S2, S2, Z1Z1);
  r2_sub(H, U2, U1);
  r2_sub(rr, S2, S1);
  r2_add(rr, rr, rr);
  r2_add(I, H, H);
  r2_sqr(I, I);
  r2_mul(J, H, I);
  r2_mul(V, U1, I);
  r2_add(U2, RG2_Z(p1), RG2_Z(p2));    // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H
  r2_sqr(U2, U2);
  r2_sub(U2, U2, Z1Z1);
  r2_sub(U2, U2, Z2Z2);
  r2_mul(RG2_Z(o), U2, H);
  r2_sqr(U1, rr);
  r2_sub(U1, U1, J);
  r2_sub(U1, U1, V);
  r2_sub(RG2_X(o), U1, V);             // X3 = r^2 - J - 2V
  r2_sub(V, V, RG2_X(o));
  r2_mul(V, rr, V);
  r2_mul(S1, S1, J);
  r2_add(S1, S1, S1);
  r2_sub(RG2_Y(o), V, S1);             // Y3 = r (V - X3) - 2 S1 J
  rg2_dbl(d, p1);
  const bool inf1 = r2_is_zero(RG2_Z(p1)), inf2 = r2_is_zero(RG2_Z(p2));
  const bool h0 = r2_is_zero(H), r0 = r2_is_zero(rr);
  for (int w = 0; w < RG2_W; ++w) {
    // infinity (1, 1, 0): one in the c0 words of X and Y
    const uint32_t inf_w = (w < RQ_W) ? BLS_ONE[w]
        : (w >= RQ2_W && w < RQ2_W + RQ_W) ? BLS_ONE[w - RQ2_W] : 0u;
    const uint32_t sum_w = h0 ? (r0 ? d[w] : inf_w) : o[w];
    r[w] = inf2 ? p1[w] : (inf1 ? p2[w] : sum_w);
  }
}

BLS_FN void rg2_neg(uint32_t* r, const uint32_t* p) {
  if (r != p) {
    rq_copy(RG2_X(r), RG2_X(p), RQ2_W);
    rq_copy(RG2_Z(r), RG2_Z(p), RQ2_W);
  }
  r2_neg(RG2_Y(r), RG2_Y(p));
}

// r = [x] p for the BLS parameter x = -|x|: double-and-add over the 63 bits
// of |x| below its leading one (63 doublings, 5 adds), then negate; r must
// not alias p
BLS_CALL void rg2_mul_by_x(uint32_t* r, const uint32_t* p) {
  rq_copy(r, p, RG2_W);
  for (int i = 62; i >= 0; --i) {
    rg2_dbl(r, r);
    if ((BLS_X_ABS >> i) & 1ull) rg2_add(r, r, p);
  }
  rg2_neg(r, r);
}

// psi(X, Y, Z) = (conj(X) c_x, conj(Y) c_y, conj(Z)), the untwist-Frobenius-
// twist endomorphism on Jacobian coordinates (conjugation is a field
// automorphism, so it commutes with X / Z^2 and Y / Z^3); c holds c_x, c_y
// (48 words).  r may alias p.
BLS_FN void rg2_psi(uint32_t* r, const uint32_t* p, const uint32_t* c) {
  r2_conj(RG2_X(r), RG2_X(p));
  r2_mul(RG2_X(r), RG2_X(r), c);
  r2_conj(RG2_Y(r), RG2_Y(p));
  r2_mul(RG2_Y(r), RG2_Y(r), c + RQ2_W);
  r2_conj(RG2_Z(r), RG2_Z(p));
}

// h_eff p by the Budroni-Pintore method (RFC 9380 G.3,
// clear_cofactor_bls12381_g2): [x^2 - x - 1] p + [x - 1] psi(p) +
// psi^2(2p), in the RFC's steps; then affine (x, y) = (X / Z^2, Y / Z^3),
// written as 48 words (zeros at infinity), and whether it is infinity.
// Any formula gives the same canonical affine words, so they equal the
// ladder's (bls381.cuh pt_ladder over h_eff's bits, then the affine
// normalization) bit for bit.
BLS_FN void cofactor_elem(const uint32_t* pin, const uint32_t* psi_c,
                          uint32_t* xy, uint8_t* inf) {
  uint32_t p[RG2_W], t1[RG2_W], t2[RG2_W], t3[RG2_W], n[RG2_W];
  rq_copy(p, pin, RG2_W);
  rg2_mul_by_x(t1, p);                  // t1 = [x] p
  rg2_psi(t2, p, psi_c);                // t2 = psi(p)
  rg2_dbl(t3, p);                       // t3 = psi^2(2 p)
  rg2_psi(t3, t3, psi_c);
  rg2_psi(t3, t3, psi_c);
  rg2_neg(n, t2);
  rg2_add(t3, t3, n);                   // t3 = t3 - t2
  rg2_add(t2, t1, t2);                  // t2 = t1 + t2
  rg2_mul_by_x(n, t2);                  // t2 = [x] t2
  rg2_add(t3, t3, n);                   // t3 = t3 + t2
  rg2_neg(n, t1);
  rg2_add(t3, t3, n);                   // t3 = t3 - t1
  rg2_neg(n, p);
  rg2_add(t3, t3, n);                   // t3 - p
  // at infinity Z = 0 inverts to 0 and the affine words come out zero
  uint32_t zi[RQ2_W], zi2[RQ2_W];
  r2_inv(zi, RG2_Z(t3));
  r2_sqr(zi2, zi);
  r2_mul(xy, RG2_X(t3), zi2);
  r2_mul(zi, zi2, zi);
  r2_mul(xy + RQ2_W, RG2_Y(t3), zi);
  *inf = r2_is_zero(RG2_Z(t3)) ? 1 : 0;
}
