// BLS12-381 device functions for the port's first kernels (sm_90a): the
// base field Fq, the tower Fq2 -> Fq6 -> Fq12 and Jacobian G1/G2 points.
// The pairing's Miller loop and final exponentiation are the warp levels
// of bls381_check.cuh, on the register-resident bls381_reg.cuh.
//
// Replaces the limb arithmetic the TPU ran as XLA programs:
// consensus_specs_tpu/ops/fq.py (`mul` = `_conv` + `_mont_reduce`, 32 x
// 12-bit limbs), ops/fq_tower.py, ops/curve_jax.py and ops/pairing_jax.py.
// The TPU layout (12-bit limbs so every product fits its 32-bit lanes, a
// Toeplitz einsum per product) is not carried over: an Fq element here is
// 12 x 32-bit words, little-endian, in Montgomery form with R = 2^384 (the
// same integers as the plain version's limbs, ops/fq.py to_words), and a
// product is CIOS Montgomery multiplication with 32 x 32 -> 64-bit partial
// products and one final conditional subtract, so every value stays
// canonical (< q).
//
// What bounds these kernels on the card: operations, the 32-bit integer
// multiplies of the CIOS products (2 * 12 * 12 * 2 + 12 = 588 a product at
// 64 multiplies a clock an SM).  The first design keeps one thread per
// element or point with its whole state in registers and local memory; the
// tower and point functions are out of line (__noinline__) to keep the
// build of all kernels short.
//
// Any correct formula gives the same canonical field element, so the field
// and tower formulas are free.  Two things set a representation and follow
// the reference step by step: the Jacobian coordinates of the point
// formulas (dbl-2009-l, add-2007-bl, with the reference's select semantics
// at infinity, equal and negated inputs) and the Granger-Scott cyclotomic
// square (not a square off the cyclotomic subgroup).  The public exponents
// (q - 2, a ladder's bits) skip their zero bits with a branch; the
// reference selects, with the same result.
//
// The header also compiles as host C++ (no __CUDACC__): the same functions,
// so they can be checked against the plain version without a card.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define BLS_FN static __device__ __forceinline__
#define BLS_CALL static __device__ __noinline__
#define BLS_CONST static __constant__
#else
#define BLS_FN static inline
#define BLS_CALL static
#define BLS_CONST static const
#endif

#define BLS_NW 12

struct fp { uint32_t v[BLS_NW]; };
struct fp2 { fp c0, c1; };
struct fp6 { fp2 c0, c1, c2; };
struct fp12 { fp6 c0, c1; };
template <typename F> struct pt { F x, y, z; };

BLS_CONST uint32_t BLS_Q[BLS_NW] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u,
    0x6730d2a0u, 0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u,
    0x397fe69au, 0x1a0111eau};
// q - 2, the Fermat inverse's exponent (bit 380 is its top bit)
BLS_CONST uint32_t BLS_QM2[BLS_NW] = {
    0xffffaaa9u, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u,
    0x6730d2a0u, 0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u,
    0x397fe69au, 0x1a0111eau};
// R mod q: one in Montgomery form
BLS_CONST uint32_t BLS_ONE[BLS_NW] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau,
    0x5f489857u, 0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u,
    0xfa80e493u, 0x15f65ec3u};
#define BLS_QINV 0xfffcfffdu   // -q^{-1} mod 2^32
// |x| = 0xd201000000010000; the Miller loop and exp-by-x
// (bls381_check.cuh) walk its bits 62..0 (below the leading one)
#define BLS_X_ABS 0xd201000000010000ull
// Frobenius constants XI^(k(q-1)/6), Montgomery form, for the fq12
// components in layout order (k = 0, 2, 4, 1, 3, 5)
BLS_CONST uint32_t BLS_FROB[6][2][BLS_NW] = {
    {{0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau,
      0x5f489857u, 0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u,
      0xfa80e493u, 0x15f65ec3u},
     {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}},
    {{0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
     {0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u, 0xd3851b95u,
      0x587042afu, 0x01bacb9eu, 0x8eb60ebeu, 0x83d050d2u, 0x03f97d6eu,
      0x54638741u, 0x18f02065u}},
    {{0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u, 0x309b7e2cu,
      0x50880866u, 0x7e881024u, 0xa20d1b8cu, 0xe2db9068u, 0x14e4f04fu,
      0x1564853au, 0x14e56d3fu},
     {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}},
    {{0xb319d465u, 0x07089552u, 0xb50a8313u, 0xc6695f92u, 0xd117228fu,
      0x97e83cccu, 0xb2dc29eeu, 0xa35baecau, 0x5daace4du, 0x1ce393eau,
      0xb0fb66ebu, 0x08f2220fu},
     {0x4ce5d646u, 0xb2f66aadu, 0xfc497cecu, 0x5842a06bu, 0x2599d394u,
      0xcf4895d4u, 0x40a8e8d0u, 0xc11b9cbau, 0xe5a0de89u, 0x2e3813cbu,
      0x88847fafu, 0x110eefdau}},
    {{0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u,
      0x2f088dd8u, 0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u,
      0xbbfd87d2u, 0x0e2b7eedu},
     {0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u,
      0x2f088dd8u, 0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u,
      0xbbfd87d2u, 0x0e2b7eedu}},
    {{0x0dbce43fu, 0x82d83cf5u, 0xdf9d018fu, 0xa2813e53u, 0x3c65e181u,
      0xc6f0caa5u, 0x8d50fe95u, 0x7525cf52u, 0xf4798a6bu, 0x4a85ed50u,
      0x6cf8eebdu, 0x171da0fdu},
     {0xf242c66cu, 0x3726c30au, 0xd1b6fe70u, 0x7c2ac1aau, 0xba4b14a2u,
      0xa04007fbu, 0x66341429u, 0xef517c32u, 0x4ed2226bu, 0x0095ba65u,
      0xcc86f7ddu, 0x02e370ecu}}};

// ---------------------------------------------------------------------------
// Fq
// ---------------------------------------------------------------------------

BLS_FN fp fp_zero() {
  fp r;
  for (int i = 0; i < BLS_NW; ++i) r.v[i] = 0;
  return r;
}

BLS_FN fp fp_one() {
  fp r;
  for (int i = 0; i < BLS_NW; ++i) r.v[i] = BLS_ONE[i];
  return r;
}

BLS_FN bool fp_is_zero(const fp& a) {
  uint32_t acc = 0;
  for (int i = 0; i < BLS_NW; ++i) acc |= a.v[i];
  return acc == 0;
}

BLS_FN bool fp_eq(const fp& a, const fp& b) {
  uint32_t acc = 0;
  for (int i = 0; i < BLS_NW; ++i) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

// r = t - q over 12 words; returns the borrow out (1 when t < q)
BLS_FN uint32_t fp_sub_q(const uint32_t* t, fp& r) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < BLS_NW; ++i) {
    const uint64_t d = (uint64_t)t[i] - BLS_Q[i] - borrow;
    r.v[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  return borrow;
}

// (a + b) mod q; a + b < 2q < 2^382 never carries out of 12 words
BLS_FN fp fp_add(const fp& a, const fp& b) {
  fp s, d;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < BLS_NW; ++i) {
    c += (uint64_t)a.v[i] + b.v[i];
    s.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return fp_sub_q(s.v, d) ? s : d;
}

// (a - b) mod q: a - b, plus q where it borrowed
BLS_FN fp fp_sub(const fp& a, const fp& b) {
  fp d;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < BLS_NW; ++i) {
    const uint64_t t = (uint64_t)a.v[i] - b.v[i] - borrow;
    d.v[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  if (borrow) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < BLS_NW; ++i) {
      c += (uint64_t)d.v[i] + BLS_Q[i];
      d.v[i] = (uint32_t)c;
      c >>= 32;
    }
  }
  return d;
}

BLS_FN fp fp_neg(const fp& a) {
  return fp_is_zero(a) ? a : fp_sub(fp_zero(), a);
}

// Montgomery product a * b * 2^-384 mod q by CIOS (coarsely integrated
// operand scanning), canonical for canonical inputs: the running value
// stays below 2q, so one conditional subtract ends it.
BLS_CALL fp fp_mul(const fp& a, const fp& b) {
  uint32_t t[BLS_NW + 2];
#pragma unroll
  for (int i = 0; i < BLS_NW + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < BLS_NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < BLS_NW; ++j) {
      c += (uint64_t)a.v[j] * b.v[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[BLS_NW];
    t[BLS_NW] = (uint32_t)c;
    t[BLS_NW + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * BLS_QINV;
    c = ((uint64_t)m * BLS_Q[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < BLS_NW; ++j) {
      c += (uint64_t)m * BLS_Q[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[BLS_NW];
    t[BLS_NW - 1] = (uint32_t)c;
    t[BLS_NW] = t[BLS_NW + 1] + (uint32_t)(c >> 32);
  }
  fp r, d;
#pragma unroll
  for (int i = 0; i < BLS_NW; ++i) r.v[i] = t[i];
  const uint32_t borrow = fp_sub_q(t, d);
  return (t[BLS_NW] || !borrow) ? d : r;
}

BLS_FN fp fp_sqr(const fp& a) { return fp_mul(a, a); }

// a^(q-2) (0 -> 0): square-and-multiply from below the top bit of q - 2
BLS_CALL fp fp_inv(const fp& a) {
  fp acc = a;
  for (int i = 379; i >= 0; --i) {
    acc = fp_sqr(acc);
    if ((BLS_QM2[i >> 5] >> (i & 31)) & 1u) acc = fp_mul(acc, a);
  }
  return acc;
}

// ---------------------------------------------------------------------------
// Fq2 = Fq[u] / (u^2 + 1)
// ---------------------------------------------------------------------------

BLS_FN fp2 fp2_make(const fp& a, const fp& b) {
  fp2 r;
  r.c0 = a;
  r.c1 = b;
  return r;
}

BLS_FN fp2 fp2_zero() { return fp2_make(fp_zero(), fp_zero()); }
BLS_FN fp2 fp2_one() { return fp2_make(fp_one(), fp_zero()); }
BLS_FN bool fp2_is_zero(const fp2& a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}
BLS_FN fp2 fp2_add(const fp2& a, const fp2& b) {
  return fp2_make(fp_add(a.c0, b.c0), fp_add(a.c1, b.c1));
}
BLS_FN fp2 fp2_sub(const fp2& a, const fp2& b) {
  return fp2_make(fp_sub(a.c0, b.c0), fp_sub(a.c1, b.c1));
}
BLS_FN fp2 fp2_neg(const fp2& a) {
  return fp2_make(fp_neg(a.c0), fp_neg(a.c1));
}
BLS_FN fp2 fp2_conj(const fp2& a) { return fp2_make(a.c0, fp_neg(a.c1)); }
// times XI = 1 + u: (a0 - a1, a0 + a1)
BLS_FN fp2 fp2_mul_xi(const fp2& a) {
  return fp2_make(fp_sub(a.c0, a.c1), fp_add(a.c0, a.c1));
}

// Karatsuba: 3 Fq products
BLS_CALL fp2 fp2_mul(const fp2& a, const fp2& b) {
  const fp v0 = fp_mul(a.c0, b.c0);
  const fp v1 = fp_mul(a.c1, b.c1);
  const fp v2 = fp_mul(fp_add(a.c0, a.c1), fp_add(b.c0, b.c1));
  return fp2_make(fp_sub(v0, v1), fp_sub(v2, fp_add(v0, v1)));
}

// (a0 + a1)(a0 - a1), 2 a0 a1
BLS_CALL fp2 fp2_sqr(const fp2& a) {
  const fp t = fp_mul(a.c0, a.c1);
  return fp2_make(fp_mul(fp_add(a.c0, a.c1), fp_sub(a.c0, a.c1)),
                  fp_add(t, t));
}

// (a0 - a1 u) / (a0^2 + a1^2)
BLS_CALL fp2 fp2_inv(const fp2& a) {
  const fp ninv = fp_inv(fp_add(fp_sqr(a.c0), fp_sqr(a.c1)));
  return fp2_make(fp_mul(a.c0, ninv), fp_mul(fp_neg(a.c1), ninv));
}

// ---------------------------------------------------------------------------
// Fq6 = Fq2[v] / (v^3 - XI)
// ---------------------------------------------------------------------------

BLS_FN fp6 fp6_make(const fp2& a, const fp2& b, const fp2& c) {
  fp6 r;
  r.c0 = a;
  r.c1 = b;
  r.c2 = c;
  return r;
}
BLS_FN fp6 fp6_add(const fp6& a, const fp6& b) {
  return fp6_make(fp2_add(a.c0, b.c0), fp2_add(a.c1, b.c1),
                  fp2_add(a.c2, b.c2));
}
BLS_FN fp6 fp6_sub(const fp6& a, const fp6& b) {
  return fp6_make(fp2_sub(a.c0, b.c0), fp2_sub(a.c1, b.c1),
                  fp2_sub(a.c2, b.c2));
}
BLS_FN fp6 fp6_neg(const fp6& a) {
  return fp6_make(fp2_neg(a.c0), fp2_neg(a.c1), fp2_neg(a.c2));
}
// (c0, c1, c2) -> (XI c2, c0, c1)
BLS_FN fp6 fp6_mul_by_v(const fp6& a) {
  return fp6_make(fp2_mul_xi(a.c2), a.c0, a.c1);
}

// Karatsuba-CH: 6 Fq2 products
BLS_CALL fp6 fp6_mul(const fp6& a, const fp6& b) {
  const fp2 v0 = fp2_mul(a.c0, b.c0);
  const fp2 v1 = fp2_mul(a.c1, b.c1);
  const fp2 v2 = fp2_mul(a.c2, b.c2);
  const fp2 t01 = fp2_mul(fp2_add(a.c0, a.c1), fp2_add(b.c0, b.c1));
  const fp2 t02 = fp2_mul(fp2_add(a.c0, a.c2), fp2_add(b.c0, b.c2));
  const fp2 t12 = fp2_mul(fp2_add(a.c1, a.c2), fp2_add(b.c1, b.c2));
  return fp6_make(
      fp2_add(v0, fp2_mul_xi(fp2_sub(t12, fp2_add(v1, v2)))),
      fp2_add(fp2_sub(t01, fp2_add(v0, v1)), fp2_mul_xi(v2)),
      fp2_add(fp2_sub(t02, fp2_add(v0, v2)), v1));
}

BLS_CALL fp6 fp6_mul_fp2(const fp6& a, const fp2& s) {
  return fp6_make(fp2_mul(a.c0, s), fp2_mul(a.c1, s), fp2_mul(a.c2, s));
}

BLS_CALL fp6 fp6_inv(const fp6& a) {
  const fp2 c0 = fp2_sub(fp2_sqr(a.c0), fp2_mul_xi(fp2_mul(a.c1, a.c2)));
  const fp2 c1 = fp2_sub(fp2_mul_xi(fp2_sqr(a.c2)), fp2_mul(a.c0, a.c1));
  const fp2 c2 = fp2_sub(fp2_sqr(a.c1), fp2_mul(a.c0, a.c2));
  const fp2 norm = fp2_add(
      fp2_mul(a.c0, c0),
      fp2_mul_xi(fp2_add(fp2_mul(a.c2, c1), fp2_mul(a.c1, c2))));
  return fp6_mul_fp2(fp6_make(c0, c1, c2), fp2_inv(norm));
}

// ---------------------------------------------------------------------------
// Fq12 = Fq6[w] / (w^2 - v)
// ---------------------------------------------------------------------------

BLS_FN fp12 fp12_make(const fp6& a, const fp6& b) {
  fp12 r;
  r.c0 = a;
  r.c1 = b;
  return r;
}
BLS_FN fp12 fp12_conj(const fp12& a) { return fp12_make(a.c0, fp6_neg(a.c1)); }

// Karatsuba over Fq6: 3 Fq6 products
BLS_CALL fp12 fp12_mul(const fp12& a, const fp12& b) {
  const fp6 v0 = fp6_mul(a.c0, b.c0);
  const fp6 v1 = fp6_mul(a.c1, b.c1);
  const fp6 v2 = fp6_mul(fp6_add(a.c0, a.c1), fp6_add(b.c0, b.c1));
  return fp12_make(fp6_add(v0, fp6_mul_by_v(v1)),
                   fp6_sub(v2, fp6_add(v0, v1)));
}

// t = a0 a1; c0 = (a0 + a1)(a0 + v a1) - t - v t; c1 = 2t
BLS_CALL fp12 fp12_sqr(const fp12& a) {
  const fp6 t = fp6_mul(a.c0, a.c1);
  const fp6 s = fp6_mul(fp6_add(a.c0, a.c1),
                        fp6_add(a.c0, fp6_mul_by_v(a.c1)));
  return fp12_make(fp6_sub(s, fp6_add(t, fp6_mul_by_v(t))), fp6_add(t, t));
}

// x -> x^q: conjugate each Fq2 component, times its Frobenius constant
BLS_CALL fp12 fp12_frob(const fp12& a) {
  fp2 c[6] = {a.c0.c0, a.c0.c1, a.c0.c2, a.c1.c0, a.c1.c1, a.c1.c2};
  for (int j = 0; j < 6; ++j) {
    fp2 g;
    for (int i = 0; i < BLS_NW; ++i) {
      g.c0.v[i] = BLS_FROB[j][0][i];
      g.c1.v[i] = BLS_FROB[j][1][i];
    }
    c[j] = fp2_mul(fp2_conj(c[j]), g);
  }
  return fp12_make(fp6_make(c[0], c[1], c[2]), fp6_make(c[3], c[4], c[5]));
}

BLS_FN fp12 fp12_frob_n(const fp12& a, int power) {
  fp12 r = a;
  for (int i = 0; i < power; ++i) r = fp12_frob(r);
  return r;
}

// 2 (t -/+ z) + t
BLS_FN fp2 cyc_dbl_plus(const fp2& t, const fp2& z, bool minus) {
  const fp2 base = minus ? fp2_sub(t, z) : fp2_add(t, z);
  return fp2_add(fp2_add(base, base), t);
}

// Granger-Scott squaring of a unitary element, in the reference's
// component naming: layout positions 0..5 hold z0, z4, z3, z2, z1, z5
BLS_CALL fp12 fp12_cyc_sqr(const fp12& a) {
  const fp2 z0 = a.c0.c0, z4 = a.c0.c1, z3 = a.c0.c2;
  const fp2 z2 = a.c1.c0, z1 = a.c1.c1, z5 = a.c1.c2;
  const fp2 in[9] = {z0, z1, fp2_add(z0, z1), z2, z3, fp2_add(z2, z3),
                     z4, z5, fp2_add(z4, z5)};
  fp2 s[9];
  for (int i = 0; i < 9; ++i) s[i] = fp2_sqr(in[i]);
  // Fq4 square i: (XI t1 + t0, (tsum - t0) - t1)
  fp2 lo[3], hi[3];
  for (int k = 0; k < 3; ++k) {
    lo[k] = fp2_add(fp2_mul_xi(s[3 * k + 1]), s[3 * k]);
    hi[k] = fp2_sub(fp2_sub(s[3 * k + 2], s[3 * k]), s[3 * k + 1]);
  }
  const fp2 z0n = cyc_dbl_plus(lo[0], z0, true);
  const fp2 z1n = cyc_dbl_plus(hi[0], z1, false);
  const fp2 z4n = cyc_dbl_plus(lo[1], z4, true);
  const fp2 z5n = cyc_dbl_plus(hi[1], z5, false);
  const fp2 z2n = cyc_dbl_plus(fp2_mul_xi(hi[2]), z2, false);
  const fp2 z3n = cyc_dbl_plus(lo[2], z3, true);
  return fp12_make(fp6_make(z0n, z4n, z3n), fp6_make(z2n, z1n, z5n));
}

BLS_CALL fp12 fp12_inv(const fp12& a) {
  const fp6 t = fp6_sub(fp6_mul(a.c0, a.c0),
                        fp6_mul_by_v(fp6_mul(a.c1, a.c1)));
  const fp6 tinv = fp6_inv(t);
  return fp12_make(fp6_mul(a.c0, tinv), fp6_neg(fp6_mul(a.c1, tinv)));
}

// ---------------------------------------------------------------------------
// Jacobian points over Fq (G1) and Fq2 (G2); infinity is Z = 0
// ---------------------------------------------------------------------------

BLS_FN fp f_add(const fp& a, const fp& b) { return fp_add(a, b); }
BLS_FN fp f_sub(const fp& a, const fp& b) { return fp_sub(a, b); }
BLS_FN fp f_mul(const fp& a, const fp& b) { return fp_mul(a, b); }
BLS_FN fp f_sqr(const fp& a) { return fp_sqr(a); }
BLS_FN bool f_is_zero(const fp& a) { return fp_is_zero(a); }
BLS_FN void f_set_one(fp& a) { a = fp_one(); }
BLS_FN void f_set_zero(fp& a) { a = fp_zero(); }
BLS_FN fp2 f_add(const fp2& a, const fp2& b) { return fp2_add(a, b); }
BLS_FN fp2 f_sub(const fp2& a, const fp2& b) { return fp2_sub(a, b); }
BLS_FN fp2 f_mul(const fp2& a, const fp2& b) { return fp2_mul(a, b); }
BLS_FN fp2 f_sqr(const fp2& a) { return fp2_sqr(a); }
BLS_FN bool f_is_zero(const fp2& a) { return fp2_is_zero(a); }
BLS_FN void f_set_one(fp2& a) { a = fp2_one(); }
BLS_FN void f_set_zero(fp2& a) { a = fp2_zero(); }
BLS_FN fp f_inv(const fp& a) { return fp_inv(a); }
BLS_FN fp2 f_inv(const fp2& a) { return fp2_inv(a); }

template <typename F>
BLS_FN pt<F> pt_infinity() {
  pt<F> r;
  f_set_one(r.x);
  f_set_one(r.y);
  f_set_zero(r.z);
  return r;
}

// dbl-2009-l (a = 0), applied as is to every input (infinity (1, 1, 0)
// doubles to itself)
template <typename F>
BLS_CALL pt<F> pt_double(const pt<F>& p) {
  const F A = f_sqr(p.x);
  const F B = f_sqr(p.y);
  const F C = f_sqr(B);
  const F t = f_sqr(f_add(p.x, B));
  F D = f_sub(f_sub(t, A), C);
  D = f_add(D, D);
  const F E = f_add(f_add(A, A), A);
  const F Fv = f_sqr(E);
  pt<F> r;
  r.x = f_sub(Fv, f_add(D, D));
  F C8 = f_add(C, C);
  C8 = f_add(C8, C8);
  C8 = f_add(C8, C8);
  r.y = f_sub(f_mul(E, f_sub(D, r.x)), C8);
  const F yz = f_mul(p.y, p.z);
  r.z = f_add(yz, yz);
  return r;
}

// add-2007-bl, with the reference's selects as branches: infinity on
// either side returns the other input (p2 infinite wins), equal inputs
// double, opposite inputs give (1, 1, 0)
template <typename F>
BLS_CALL pt<F> pt_add(const pt<F>& p1, const pt<F>& p2) {
  if (f_is_zero(p2.z)) return p1;
  if (f_is_zero(p1.z)) return p2;
  const F Z1Z1 = f_sqr(p1.z);
  const F Z2Z2 = f_sqr(p2.z);
  const F U1 = f_mul(p1.x, Z2Z2);
  const F U2 = f_mul(p2.x, Z1Z1);
  const F S1 = f_mul(f_mul(p1.y, p2.z), Z2Z2);
  const F S2 = f_mul(f_mul(p2.y, p1.z), Z1Z1);
  const F H = f_sub(U2, U1);
  F r = f_sub(S2, S1);
  r = f_add(r, r);
  if (f_is_zero(H)) {
    if (f_is_zero(r)) return pt_double(p1);
    return pt_infinity<F>();
  }
  const F I = f_sqr(f_add(H, H));
  const F J = f_mul(H, I);
  const F V = f_mul(U1, I);
  pt<F> o;
  o.x = f_sub(f_sub(f_sqr(r), J), f_add(V, V));
  const F S1J = f_mul(S1, J);
  o.y = f_sub(f_mul(r, f_sub(V, o.x)), f_add(S1J, S1J));
  const F Zs = f_sqr(f_add(p1.z, p2.z));
  o.z = f_mul(f_sub(f_sub(Zs, Z1Z1), Z2Z2), H);
  return o;
}

// msb-first double-and-add from infinity over nbits bits (one byte a bit)
template <typename F>
BLS_FN pt<F> pt_ladder(const pt<F>& p, const uint8_t* bits, int64_t nbits) {
  pt<F> acc = pt_infinity<F>();
  for (int64_t i = 0; i < nbits; ++i) {
    acc = pt_double(acc);
    if (bits[i]) acc = pt_add(acc, p);
  }
  return acc;
}

// (x, y) = (X / Z^2, Y / Z^3), or (sx, sy) at infinity; returns whether p
// is infinity.  Affine values are canonical: any formula gives these bits.
template <typename F>
BLS_FN bool pt_affine(const pt<F>& p, const F& sx, const F& sy, F& x, F& y) {
  if (f_is_zero(p.z)) {
    x = sx;
    y = sy;
    return true;
  }
  const F zi = f_inv(p.z);
  const F zi2 = f_sqr(zi);
  x = f_mul(p.x, zi2);
  y = f_mul(p.y, f_mul(zi2, zi));
  return false;
}

// ---------------------------------------------------------------------------
// element access: the kernels' tensors are flat uint32 words in the
// struct layouts above (fp 12, fp2 24, fp12 144, G1 point 36, G2 point 72)
// ---------------------------------------------------------------------------

template <typename T>
BLS_FN T bls_load(const uint32_t* src) {
  T r;
  uint32_t* dst = reinterpret_cast<uint32_t*>(&r);
  for (int i = 0; i < (int)(sizeof(T) / 4); ++i) dst[i] = src[i];
  return r;
}

template <typename T>
BLS_FN void bls_store(uint32_t* dst, const T& v) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(&v);
  for (int i = 0; i < (int)(sizeof(T) / 4); ++i) dst[i] = src[i];
}

// ---------------------------------------------------------------------------
// per-element bodies of the kernels (the host build calls the same)
// ---------------------------------------------------------------------------

// bls381_field.cu's op codes, in the order of ops/bls381_cuda.py FIELD_OPS
enum FieldOp {
  OP_FQ_MUL, OP_FQ_ADD, OP_FQ_SUB, OP_FQ_NEG, OP_FQ_INV,
  OP_FQ2_MUL, OP_FQ2_SQUARE, OP_FQ2_INV,
  OP_FQ12_MUL, OP_FQ12_SQUARE, OP_FQ12_CYCLOTOMIC_SQUARE,
  OP_FQ12_FROBENIUS1, OP_FQ12_FROBENIUS2, OP_FQ12_FROBENIUS3,
  OP_FQ12_CONJ, OP_FQ12_INV,
  OP_G1_ADD, OP_G1_DOUBLE, OP_G2_ADD, OP_G2_DOUBLE,
  OP_COUNT
};

// 32-bit words of one element of each op's type
BLS_FN int field_op_words(int op) {
  if (op <= OP_FQ_INV) return BLS_NW;
  if (op <= OP_FQ2_INV) return 2 * BLS_NW;
  if (op <= OP_FQ12_INV) return 12 * BLS_NW;
  if (op <= OP_G1_DOUBLE) return 3 * BLS_NW;
  return 6 * BLS_NW;
}

// out = op(a, b) for one element (b unread by unary ops)
BLS_FN void field_op_elem(int op, const uint32_t* a, const uint32_t* b,
                          uint32_t* out) {
  switch (op) {
    case OP_FQ_MUL:
      bls_store(out, fp_mul(bls_load<fp>(a), bls_load<fp>(b)));
      break;
    case OP_FQ_ADD:
      bls_store(out, fp_add(bls_load<fp>(a), bls_load<fp>(b)));
      break;
    case OP_FQ_SUB:
      bls_store(out, fp_sub(bls_load<fp>(a), bls_load<fp>(b)));
      break;
    case OP_FQ_NEG: bls_store(out, fp_neg(bls_load<fp>(a))); break;
    case OP_FQ_INV: bls_store(out, fp_inv(bls_load<fp>(a))); break;
    case OP_FQ2_MUL:
      bls_store(out, fp2_mul(bls_load<fp2>(a), bls_load<fp2>(b)));
      break;
    case OP_FQ2_SQUARE: bls_store(out, fp2_sqr(bls_load<fp2>(a))); break;
    case OP_FQ2_INV: bls_store(out, fp2_inv(bls_load<fp2>(a))); break;
    case OP_FQ12_MUL:
      bls_store(out, fp12_mul(bls_load<fp12>(a), bls_load<fp12>(b)));
      break;
    case OP_FQ12_SQUARE: bls_store(out, fp12_sqr(bls_load<fp12>(a))); break;
    case OP_FQ12_CYCLOTOMIC_SQUARE:
      bls_store(out, fp12_cyc_sqr(bls_load<fp12>(a)));
      break;
    case OP_FQ12_FROBENIUS1:
    case OP_FQ12_FROBENIUS2:
    case OP_FQ12_FROBENIUS3:
      bls_store(out, fp12_frob_n(bls_load<fp12>(a),
                                 op - OP_FQ12_FROBENIUS1 + 1));
      break;
    case OP_FQ12_CONJ: bls_store(out, fp12_conj(bls_load<fp12>(a))); break;
    case OP_FQ12_INV: bls_store(out, fp12_inv(bls_load<fp12>(a))); break;
    case OP_G1_ADD:
      bls_store(out, pt_add(bls_load<pt<fp>>(a), bls_load<pt<fp>>(b)));
      break;
    case OP_G1_DOUBLE: bls_store(out, pt_double(bls_load<pt<fp>>(a))); break;
    case OP_G2_ADD:
      bls_store(out, pt_add(bls_load<pt<fp2>>(a), bls_load<pt<fp2>>(b)));
      break;
    case OP_G2_DOUBLE:
      bls_store(out, pt_double(bls_load<pt<fp2>>(a)));
      break;
    default: break;
  }
}

// pt_ladder for one G2 point: pts and out hold 72 words a point (the host
// tests hold pt_ladder, K4's legs' ladder, through these two; the G1 and
// G2 ladder kernels run bls381_ladder.cuh's windowed body)
BLS_FN void g2_ladder_elem(const uint32_t* p, const uint8_t* bits,
                           int64_t nbits, uint32_t* out) {
  bls_store(out, pt_ladder(bls_load<pt<fp2>>(p), bits, nbits));
}

// pt_ladder for one G1 point: p and out hold 36 words a point
BLS_FN void g1_ladder_elem(const uint32_t* p, const uint8_t* bits,
                           int64_t nbits, uint32_t* out) {
  bls_store(out, pt_ladder(bls_load<pt<fp>>(p), bits, nbits));
}

// the fold's affine constants, in words: the G1 and G2 generators (the
// substitutes at infinity) and -G1 (the base of the folded signature leg);
// the fold's legs are in bls381_fold.cuh
enum FoldConst {
  FC_G1X = 0, FC_G1Y = 12, FC_G2X = 24, FC_G2Y = 48, FC_N1X = 72,
  FC_N1Y = 84, FC_WORDS = 96
};

// the fold's last pair (launch 3): (-G1, affine S), S the signature sum
// (72 words, Jacobian), skipped when S is infinity
BLS_FN void fold_tail_elem(const uint32_t* S, const uint32_t* consts,
                           uint32_t* g1, uint32_t* g2, uint8_t* skip) {
  fp2 xs, ys;
  const bool s_inf = pt_affine(bls_load<pt<fp2>>(S),
                               bls_load<fp2>(consts + FC_G2X),
                               bls_load<fp2>(consts + FC_G2Y), xs, ys);
  for (int i = 0; i < 2 * BLS_NW; ++i) g1[i] = consts[FC_N1X + i];
  bls_store(g2, xs);
  bls_store(g2 + 2 * BLS_NW, ys);
  *skip = s_inf ? 1 : 0;
}
