// The windowed scalar ladder of the G1 ladder (K2, bls381_msm.cu) and the
// G2 ladder (bls381_g2.cu) for Hopper (sm_90a), on bls381.cuh's struct
// layer (pt_double, pt_add).  pt_ladder, the bit-by-bit ladder of K4's
// legs (bls381_fold.cuh), stays as it is.
//
// Replaces consensus_specs_tpu/ops/msm.py:271 `g1_weighted_sweep` and
// :237 `g1_multi_exp`'s double-and-add lanes, both over
// ops/curve_jax.py `g1_scalar_mul`, and ops/msm.py:324 `g2_multi_exp`
// over curve_jax.py `g2_scalar_mul` (with the h_eff ladder of
// ops/bls_tpu.py `hash_to_g2_batch`, kept on the card by the same kernel).
//
// What bounds them: not the card's multiply rate (the blob verify's 8
// rows of 256 bits are about 0.001 ms of its multiply pipes) but each
// row's dependent chain of Fq products, about 2 us each in one warp
// (PERF.md section 6).  The old body ran a doubling a bit and an add a set
// bit behind a branch, so a warp paid the add wherever any of its rows had
// a one: at 8 or more rows nearly every bit.  This body shortens the chain
// three ways:
//
// - regular signed odd digits of LADDER_W bits: every window is exactly
//   one add of a table entry, its sign a select on Y, with no branch on a
//   digit; an even scalar s runs as s + 1 (bit 0 forced to one) and a
//   select keeps (s + 1)P - P, which never assumes rP = O, so h_eff rows
//   on points outside G2 are right;
// - the odd multiples P, 3P, ..., 31P are built in shared memory by the
//   row's LADDER_LANES lanes in LADDER_W levels ({2P}, {3P, 4P}, {5P, 7P,
//   8P}, {9P .. 15P, 16P}, {17P .. 31P}): one doubling or add deep each,
//   on lanes an almost empty card has idle;
// - a G1 row wider than 128 bits arrives split by GLV, s = s0 + s1 lambda
//   (mod r) with s0, s1 < 2^128 (ops/curve_torch.py glv_split): lane 0
//   ladders s0 over P, lane 1 s1 over phi(P) = (beta X, Y, Z) = [lambda]P,
//   whose table is beta times the X of P's (a level of two products a
//   lane), and one add joins them.  phi(P) = [lambda]P holds only on the
//   r-torsion subgroup, so the callers split only rows whose points passed
//   a subgroup check (ops/bls381_cuda.py g1_ladder).  G2 rows are never
//   split: a 64-bit weight gains nothing from psi (|x| is 64 bits) and an
//   h_eff row's point lies outside G2.
//
// LADDER_W = 5 by the chain count: a window of w costs one add and w
// doublings, the table w levels.  G1 (7 products a doubling, 16 an add):
// a 64-bit row 699 dependent products at w = 5 against 731 at 4, a split
// 256-bit row 1,380 against 1,453; G2 (16 and 43): a 64-bit row 1,707
// against 1,793.  w = 6 saves 2-3% more for twice the shared memory.
//
// Layout of a row's table (pt<F> slots): odd multiple kP at (k - 1) / 2
// (0 .. LADDER_ODD - 1), 2^j P at LADDER_EVEN_AT + j - 1 (j = 1 .. w - 1),
// phi of the odd multiples at LADDER_PHI_AT on split rows.  Every value
// that outlives a level lives in the table, so the host build (no
// __CUDACC__) runs a row's lanes in turn with the same results; the plain
// version (ops/curve_torch.py windowed_ladder, glv_ladder) takes the same
// steps in the same operand order, so the Jacobian words are equal.
#pragma once

#include "bls381.cuh"

#define LADDER_W 5            // window width, bits
#define LADDER_ODD 16         // odd multiples P .. (2^w - 1)P
#define LADDER_EVEN_AT 16     // slot of 2P; 2^j P at LADDER_EVEN_AT + j - 1
#define LADDER_ENTRIES 20     // slots of an unsplit row
#define LADDER_PHI_AT 20      // phi of the odd multiples (split rows)
#define LADDER_SPLIT_ENTRIES 36
#define LADDER_LANES 8        // a row's lanes: the last level's 2^(w-2) adds
#define LADDER_ROWS 4         // rows a block: one warp
#define LADDER_SPLIT_BITS 128 // bits of each half of a split row

// beta in Montgomery form: the cube root of unity (2^((q-1)/3))^2 mod q,
// for which (beta x, y) = [lambda](x, y) on G1, lambda = x^2 - 1 =
// 0xac45a4010001a40200000000ffffffff (the other root pairs with lambda^2)
BLS_CONST uint32_t BLS_BETA[BLS_NW] = {
    0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u, 0xd3851b95u,
    0x587042afu, 0x01bacb9eu, 0x8eb60ebeu, 0x83d050d2u, 0x03f97d6eu,
    0x54638741u, 0x18f02065u};

#if defined(__CUDACC__)
// a level: each thread runs the statement as lane threadIdx.x %
// LADDER_LANES of its row, then the block's barrier
#define LADDER_LEVEL(...)                                                  \
  do {                                                                     \
    {                                                                      \
      const int lane = static_cast<int>(threadIdx.x) % LADDER_LANES;       \
      __VA_ARGS__;                                                         \
    }                                                                      \
    __syncthreads();                                                       \
  } while (0)
#else
#define LADDER_LEVEL(...)                                                  \
  do {                                                                     \
    for (int lane = 0; lane < LADDER_LANES; ++lane) {                      \
      __VA_ARGS__;                                                         \
    }                                                                      \
  } while (0)
#endif

BLS_FN fp f_neg(const fp& a) { return fp_neg(a); }
BLS_FN fp2 f_neg(const fp2& a) { return fp2_neg(a); }

// Table level `level` (1 .. LADDER_W), lane `lane`'s part: level 1 doubles
// P; level j > 1 adds 2^(j-1) P to each odd kP with k < 2^(j-1) (lane l:
// k = 2l + 1) and, below the last level, one more lane doubles 2^(j-1) P.
// Operands are copied out of the table before the out-of-line call.
template <typename F>
BLS_FN void ladder_table_lane(pt<F>* tab, int level, int lane) {
  if (level == 1) {
    if (lane == 0) {
      const pt<F> p = tab[0];
      tab[LADDER_EVEN_AT] = pt_double(p);
    }
    return;
  }
  const int adds = 1 << (level - 2);
  if (lane < adds) {
    const pt<F> e = tab[LADDER_EVEN_AT + level - 2];
    const pt<F> k = tab[lane];
    tab[adds + lane] = pt_add(e, k);
  } else if (lane == adds && level < LADDER_W) {
    const pt<F> e = tab[LADDER_EVEN_AT + level - 2];
    tab[LADDER_EVEN_AT + level - 1] = pt_double(e);
  }
}

// Split rows: lane l writes phi of odd multiples l and l + LADDER_LANES.
BLS_FN void ladder_phi_lane(pt<fp>* tab, int lane) {
  fp beta;
  for (int i = 0; i < BLS_NW; ++i) beta.v[i] = BLS_BETA[i];
  for (int k = lane; k < LADDER_ODD; k += LADDER_LANES) {
    pt<fp> p = tab[k];
    p.x = fp_mul(p.x, beta);
    tab[LADDER_PHI_AT + k] = p;
  }
}

// bit `pos` (0 = least significant) of an msb-first row of nbits bytes
BLS_FN int ladder_bit(const uint8_t* bits, int64_t nbits, int64_t pos) {
  return pos < nbits ? (bits[nbits - 1 - pos] != 0) : 0;
}

// Windows of a row: m = ceil(nbits / LADDER_W) (at least 1).
BLS_FN int64_t ladder_windows(int64_t nbits) {
  return nbits > 0 ? (nbits + LADDER_W - 1) / LADDER_W : 1;
}

// The regular signed digit of window i (0 = least significant) of s | 1:
// the window's bits with its lowest forced to one, less 2^w where the next
// window's lowest bit is zero; the top window's digit is positive.  Odd,
// |d| < 2^w, and sum_i d_i 2^(w i) = s | 1 for s < 2^(w m).
BLS_FN int ladder_digit(const uint8_t* bits, int64_t nbits, int64_t i,
                        int64_t m) {
  int v = 1;
  for (int b = 1; b < LADDER_W; ++b)
    v |= ladder_bit(bits, nbits, i * LADDER_W + b) << b;
  if (i == m - 1) return v;
  return ladder_bit(bits, nbits, (i + 1) * LADDER_W) ? v
                                                     : v - (1 << LADDER_W);
}

// the entry of digit d: odd multiple |d| of the table, Y negated by a
// select where d < 0
template <typename F>
BLS_FN pt<F> ladder_entry(const pt<F>* odd, int d) {
  pt<F> e = odd[(d < 0 ? -d : d) >> 1];
  const F ny = f_neg(e.y);
  e.y = d < 0 ? ny : e.y;
  return e;
}

// s P over the odd multiples `odd` of P and s's msb-first bit row: the top
// digit's entry, then per window w doublings and one add; an even s ran as
// s + 1, and a select keeps the sum with -P.
template <typename F>
BLS_FN pt<F> ladder_chain(const pt<F>* odd, const uint8_t* bits,
                          int64_t nbits) {
  const int64_t m = ladder_windows(nbits);
  pt<F> acc = ladder_entry(odd, ladder_digit(bits, nbits, m - 1, m));
  for (int64_t i = m - 2; i >= 0; --i) {
    for (int j = 0; j < LADDER_W; ++j) acc = pt_double(acc);
    const pt<F> e = ladder_entry(odd, ladder_digit(bits, nbits, i, m));
    acc = pt_add(acc, e);
  }
  pt<F> np = odd[0];
  np.y = f_neg(np.y);
  const pt<F> fixed = pt_add(acc, np);
  return ladder_bit(bits, nbits, 0) ? acc : fixed;
}

// One row of a ladder kernel: its point p (pt<F> words), its bit row (a
// split row holds s0's LADDER_SPLIT_BITS bits, then s1's; nbits is each
// half's), the product written to out.  tab is the row's table (SPLIT:
// LADDER_SPLIT_ENTRIES slots, else LADDER_ENTRIES); every thread of the
// block calls this with live false for rows past the end, so each level's
// barrier is reached by all.
template <typename F, bool SPLIT>
BLS_FN void ladder_row(pt<F>* tab, const uint32_t* p, const uint8_t* bits,
                       int64_t nbits, uint32_t* out, bool live) {
  LADDER_LEVEL(if (live && lane == 0) tab[0] = bls_load<pt<F>>(p));
  for (int level = 1; level <= LADDER_W; ++level)
    LADDER_LEVEL(if (live) ladder_table_lane(tab, level, lane));
  if constexpr (SPLIT) {
    LADDER_LEVEL(if (live) ladder_phi_lane(tab, lane));
    // s0 P into 4P's slot, s1 phi(P) into 2P's; then the join
    LADDER_LEVEL(if (live && lane < 2) tab[LADDER_EVEN_AT + 1 - lane] =
                     ladder_chain(tab + (lane ? LADDER_PHI_AT : 0),
                                  bits + lane * nbits, nbits));
    LADDER_LEVEL(if (live && lane == 0) {
      const pt<F> a = tab[LADDER_EVEN_AT + 1];
      const pt<F> b = tab[LADDER_EVEN_AT];
      bls_store(out, pt_add(a, b));
    });
  } else {
    LADDER_LEVEL(if (live && lane == 0)
                     bls_store(out, ladder_chain(tab, bits, nbits)));
  }
}
