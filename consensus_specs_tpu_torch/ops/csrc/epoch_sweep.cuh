// The epoch sweep's lane math: the device bodies of epoch_sweep.cu, which
// also compile as host C++ (no __CUDACC__), so the tests hold the kernel's
// arithmetic against the plain version without a card.
//
// Arithmetic.  Every lane value is int64 as in the reference.  Sums,
// differences and products are taken modulo 2^64 (in unsigned long long,
// which is numpy's and XLA's int64 wrap without C's signed-overflow
// undefined behaviour); divisions are floor divisions, as numpy's and
// XLA's `//`.  No product exceeds 2^63 at mainnet bounds (a million
// validators, so a total balance below 2^55 Gwei; effective balances of
// at most 2,048 ETH, below 2^41 Gwei):
//   phase0 base * attesting increments         <= 16 * eff *
//                                              sqrt(total) / incr
//                                              < 2^40
//   eff * finality_delay                       < 2^63 below 2^28 epochs
//   slashings: eff_incr (< 2^5 before electra) * adjusted balance (< 2^55)
//                                              < 2^60; electra divides
//                                              first: < 2^11 * 2^30
//   altair base * flag increments              <= eff_incr * 64 *
//                                              sqrt(total) < 2^45, and
//                                              times a weight < 2^50
//   eff * inactivity score                     < 2^63 for scores below
//                                              2^22 (a score grows by 4 an
//                                              epoch of leak: 14 years)
// so the wrap never fires on real states, and where it would in a
// numerator the kernel still agrees with the reference: the wrapped int64
// goes into the same floor division.  A shared divisor that wraps to zero
// or below ((tb // incr) * wd past 2^63), or is below one as given, is
// rejected by the wrapper (ValueError) where the reference would divide by
// it.
//
// Division.  Every divisor but one is the same in every lane (incr,
// sqrt_tb, brpe, prop_q, tb // incr, inact_q, tb, hyst_q, wd,
// (tb // incr) * wd, inact_denom), so the wrapper computes a reciprocal
// for each on the host (ops/epoch_sweep_cuda.py `_reciprocal`, the
// round-up method of Granlund and Montgomery for 63-bit numerators: l =
// ceil(log2 d), m = floor(2^(63 + l) / d) + 1 < 2^64) and a lane divides
// with two 64-bit products (`rdiv`), where a signed 64-bit `/` and `%`
// were a software routine of several tens of instructions.  A negative
// numerator n divides as ~floor(~n / d), so numpy's floor division holds
// for every int64 numerator and every divisor d >= 1.  The one divisor
// that varies by lane, the inclusion delay, takes the exact 64-bit floor
// division (`floor_div`; a 32-bit path for small delays measured no faster:
// 0.017491-0.017613 ms against 0.017860-0.017878 at 262,144 phase0 lanes,
// 0.062851-0.062861 against 0.062896-0.062907 at 2^20, with altair, which
// has no such division, 2% apart as well; scripts/torch_k1_sweep_ab.py,
// NVIDIA H100 80GB HBM3, 700 W).
//
// Epochs are uint64 with FAR_FUTURE_EPOCH = 2^64 - 1; they arrive as int64
// bit patterns and are compared as unsigned long long.  Bool columns arrive
// as torch.bool and are read as uint8.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define ES_FN static __device__ __forceinline__
#define ES_HD static __host__ __device__ __forceinline__
#else
#define ES_FN static inline
#define ES_HD static inline
#endif

typedef unsigned long long u64;
typedef long long i64;

constexpr int kOrderBits = 24;  // ops/epoch_sweep.py ORDER_BITS
constexpr u64 kFar = ~0ull;     // FAR_FUTURE_EPOCH

// Slots of the host parameter array, in order.  The Python wrapper
// (ops/epoch_sweep_cuda.py PARAMS) writes them by the same names.
enum Param : int {
  // device addresses of the columns (int64 or uint8 lanes)
  P_EFF, P_SLASHED, P_ACTIVATION, P_EXIT_EPOCH, P_ACT_ELIG, P_WITHDRAWABLE,
  P_BALANCES, P_MAX_EFF, P_SRC, P_TGT, P_HEAD, P_BEST_KEY, P_BEST_PROP,
  P_PART_PREV, P_SCORES,
  // device addresses of the outputs and of the int64[3 + n] scratch
  P_OUT_BALANCES, P_OUT_SCORES, P_OUT_EFF, P_OUT_ELIG_Q, P_OUT_EJECT,
  P_OUT_READY, P_SCRATCH,
  // lanes and switches
  P_N, P_ALTAIR, P_DO_REWARDS, P_LEAK, P_ELECTRA,
  // scalars (the four epochs as uint64 bit patterns)
  P_CUR, P_PREV, P_FINALIZED, P_SLASH_EPOCH, P_TB, P_ADJ, P_SQRT_TB,
  P_FINALITY_DELAY, P_BASE_PER_INCR, P_BIAS, P_RECOVERY, P_INACT_DENOM,
  // statics
  P_INCR, P_MAX_EB, P_EJECTION, P_HYST_Q, P_HYST_DOWN, P_HYST_UP, P_BRF,
  P_BRPE, P_PROP_Q, P_INACT_Q, P_WD, P_TARGET_FLAG, P_FLAG0, P_WEIGHT0,
  P_IS_HEAD0, P_FLAG1, P_WEIGHT1, P_IS_HEAD1, P_FLAG2, P_WEIGHT2, P_IS_HEAD2,
  // the uniform divisors' reciprocals (m, l), zero where a family has none
  P_INCR_M, P_INCR_L, P_SQRT_TB_M, P_SQRT_TB_L, P_BRPE_M, P_BRPE_L,
  P_PROP_Q_M, P_PROP_Q_L, P_TOTAL_INCR_M, P_TOTAL_INCR_L, P_INACT_Q_M,
  P_INACT_Q_L, P_TB_M, P_TB_L, P_HYST_Q_M, P_HYST_Q_L, P_WD_M, P_WD_L,
  P_INCR_WD_M, P_INCR_WD_L, P_INACT_DENOM_M, P_INACT_DENOM_L,
  P_COUNT
};

// floor division by a divisor d >= 1: m = floor(2^(63 + l) / d) + 1,
// l = ceil(log2 d)
struct Recip {
  u64 m;
  int l;
};

// ---------------------------------------------------------------------------
// int64 arithmetic with numpy's semantics: wrapping +, -, *; floor //
// ---------------------------------------------------------------------------

ES_HD i64 add(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) + static_cast<u64>(b));
}
ES_HD i64 sub(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) - static_cast<u64>(b));
}
ES_HD i64 mul(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) * static_cast<u64>(b));
}
ES_HD i64 max0(i64 a) { return a > 0 ? a : 0; }

ES_HD u64 umulhi(u64 a, u64 b) {
#if defined(__CUDA_ARCH__)
  return __umul64hi(a, b);
#else
  return static_cast<u64>((static_cast<unsigned __int128>(a) * b) >> 64);
#endif
}

// floor(n / d) for every int64 n, d >= 1 the divisor of r: for u < 2^63,
// floor(u / d) = floor(m u / 2^(63 + l)), the top bits of the 127-bit
// product; a negative n as ~floor(~n / d), ~n = -n - 1 >= 0
ES_HD i64 rdiv(i64 n, Recip r) {
  const u64 u = n < 0 ? ~static_cast<u64>(n) : static_cast<u64>(n);
  const u64 q = ((umulhi(r.m, u) << 1) | ((r.m * u) >> 63)) >> r.l;
  return n < 0 ? static_cast<i64>(~q) : static_cast<i64>(q);
}

struct Sweep {
  const i64* eff;
  const uint8_t* slashed;
  const u64* activation;
  const u64* exit_epoch;
  const u64* act_elig;
  const u64* withdrawable;
  const i64* balances;
  const i64* max_eff;
  const uint8_t* src;
  const uint8_t* tgt;
  const uint8_t* head;
  const i64* best_key;
  const i64* best_prop;
  const i64* part_prev;
  const i64* scores;
  i64* out_balances;
  i64* out_scores;
  i64* out_eff;
  uint8_t* out_elig_q;
  uint8_t* out_eject;
  uint8_t* out_ready;
  u64* sums;           // scratch[0:3]
  u64* proposer_gain;  // scratch[3:3 + n]
  i64 n;
  bool altair, do_rewards, leak, electra;
  u64 cur, prev, finalized, slash_epoch;
  i64 adj, finality_delay, base_per_incr, bias, recovery;
  i64 incr, max_eb, ejection, brf, brpe;
  // the values every lane shares: (incr // hyst_q) * hyst_down and
  // * hyst_up, electra's adj // (tb // incr)
  i64 hyst_down_amt, hyst_up_amt, electra_quot;
  int target_flag;
  int flag[3];
  i64 weight[3];
  bool is_head[3];
  Recip r_incr, r_sqrt_tb, r_brpe, r_prop_q, r_total_incr, r_inact_q, r_tb,
      r_hyst_q, r_wd, r_incr_wd, r_inact_denom;
};

template <typename T>
static inline T* param_ptr(const int64_t* p, int slot) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(p[slot]));
}

static inline Recip param_recip(const int64_t* p, int slot_m) {
  Recip r;
  r.m = static_cast<u64>(p[slot_m]);
  r.l = static_cast<int>(p[slot_m + 1]);
  return r;
}

// the sweep of a host parameter array (on the host: the launcher and the
// tests' host build)
static inline Sweep sweep_from_params(const int64_t* p) {
  Sweep s;
  s.eff = param_ptr<const i64>(p, P_EFF);
  s.slashed = param_ptr<const uint8_t>(p, P_SLASHED);
  s.activation = param_ptr<const u64>(p, P_ACTIVATION);
  s.exit_epoch = param_ptr<const u64>(p, P_EXIT_EPOCH);
  s.act_elig = param_ptr<const u64>(p, P_ACT_ELIG);
  s.withdrawable = param_ptr<const u64>(p, P_WITHDRAWABLE);
  s.balances = param_ptr<const i64>(p, P_BALANCES);
  s.max_eff = param_ptr<const i64>(p, P_MAX_EFF);
  s.src = param_ptr<const uint8_t>(p, P_SRC);
  s.tgt = param_ptr<const uint8_t>(p, P_TGT);
  s.head = param_ptr<const uint8_t>(p, P_HEAD);
  s.best_key = param_ptr<const i64>(p, P_BEST_KEY);
  s.best_prop = param_ptr<const i64>(p, P_BEST_PROP);
  s.part_prev = param_ptr<const i64>(p, P_PART_PREV);
  s.scores = param_ptr<const i64>(p, P_SCORES);
  s.out_balances = param_ptr<i64>(p, P_OUT_BALANCES);
  s.out_scores = param_ptr<i64>(p, P_OUT_SCORES);
  s.out_eff = param_ptr<i64>(p, P_OUT_EFF);
  s.out_elig_q = param_ptr<uint8_t>(p, P_OUT_ELIG_Q);
  s.out_eject = param_ptr<uint8_t>(p, P_OUT_EJECT);
  s.out_ready = param_ptr<uint8_t>(p, P_OUT_READY);
  u64* scratch = param_ptr<u64>(p, P_SCRATCH);
  s.sums = scratch;
  s.proposer_gain = scratch + 3;
  s.n = p[P_N];
  s.altair = p[P_ALTAIR] != 0;
  s.do_rewards = p[P_DO_REWARDS] != 0;
  s.leak = p[P_LEAK] != 0;
  s.electra = p[P_ELECTRA] != 0;
  s.cur = static_cast<u64>(p[P_CUR]);
  s.prev = static_cast<u64>(p[P_PREV]);
  s.finalized = static_cast<u64>(p[P_FINALIZED]);
  s.slash_epoch = static_cast<u64>(p[P_SLASH_EPOCH]);
  s.adj = p[P_ADJ];
  s.finality_delay = p[P_FINALITY_DELAY];
  s.base_per_incr = p[P_BASE_PER_INCR];
  s.bias = p[P_BIAS];
  s.recovery = p[P_RECOVERY];
  s.incr = p[P_INCR];
  s.max_eb = p[P_MAX_EB];
  s.ejection = p[P_EJECTION];
  s.brf = p[P_BRF];
  s.brpe = p[P_BRPE];
  s.target_flag = static_cast<int>(p[P_TARGET_FLAG]);
  for (int k = 0; k < 3; ++k) {
    s.flag[k] = static_cast<int>(p[P_FLAG0 + 3 * k]);
    s.weight[k] = p[P_WEIGHT0 + 3 * k];
    s.is_head[k] = p[P_IS_HEAD0 + 3 * k] != 0;
  }
  s.r_incr = param_recip(p, P_INCR_M);
  s.r_sqrt_tb = param_recip(p, P_SQRT_TB_M);
  s.r_brpe = param_recip(p, P_BRPE_M);
  s.r_prop_q = param_recip(p, P_PROP_Q_M);
  s.r_total_incr = param_recip(p, P_TOTAL_INCR_M);
  s.r_inact_q = param_recip(p, P_INACT_Q_M);
  s.r_tb = param_recip(p, P_TB_M);
  s.r_hyst_q = param_recip(p, P_HYST_Q_M);
  s.r_wd = param_recip(p, P_WD_M);
  s.r_incr_wd = param_recip(p, P_INCR_WD_M);
  s.r_inact_denom = param_recip(p, P_INACT_DENOM_M);
  const i64 h = rdiv(s.incr, s.r_hyst_q);
  s.hyst_down_amt = mul(h, p[P_HYST_DOWN]);
  s.hyst_up_amt = mul(h, p[P_HYST_UP]);
  s.electra_quot = rdiv(s.adj, s.r_total_incr);
  return s;
}

// whether the sweep needs the three masked sums (pass 1), and the proposer
// scatter (pass 1, phase0)
ES_HD bool sweep_sums(const Sweep& s) {
  return s.do_rewards && !s.leak;
}
ES_HD bool sweep_scatters(const Sweep& s) {
  return !s.altair && s.do_rewards;
}

// floor(a / b) with the hardware's division (b != 0)
ES_FN i64 floor_div(i64 a, i64 b) {
  const i64 q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// ---------------------------------------------------------------------------
// lanes
// ---------------------------------------------------------------------------

struct Lane {
  bool slashed, active_prev, active_cur, eligible;
};

ES_FN Lane lane_masks(const Sweep& s, i64 i) {
  Lane l;
  const u64 activation = s.activation[i];
  const u64 exit_epoch = s.exit_epoch[i];
  l.slashed = s.slashed[i] != 0;
  l.active_prev = activation <= s.prev && s.prev < exit_epoch;
  l.active_cur = activation <= s.cur && s.cur < exit_epoch;
  l.eligible = l.active_prev ||
               (l.slashed && (s.prev + 1) < s.withdrawable[i]);
  return l;
}

ES_FN bool flag_set(i64 part, int flag) {
  return ((part >> flag) & 1) == 1;
}

// lane i's effective balance under the three attester masks (phase0:
// src/tgt/head & ~slashed; altair: active_prev & flag & ~slashed)
ES_FN void sums_lane(const Sweep& s, i64 i, u64 acc[3]) {
  if (s.slashed[i]) return;
  const u64 eff = static_cast<u64>(s.eff[i]);
  if (s.altair) {
    const u64 activation = s.activation[i];
    if (!(activation <= s.prev && s.prev < s.exit_epoch[i])) return;
    const i64 part = s.part_prev[i];
    for (int k = 0; k < 3; ++k)
      if (flag_set(part, s.flag[k])) acc[k] += eff;
  } else {
    if (s.src[i]) acc[0] += eff;
    if (s.tgt[i]) acc[1] += eff;
    if (s.head[i]) acc[2] += eff;
  }
}

// phase0's base reward of an effective balance, and its proposer's share
ES_FN i64 phase0_base(const Sweep& s, i64 eff) {
  return rdiv(rdiv(mul(eff, s.brf), s.r_sqrt_tb), s.r_brpe);
}

// whether phase0 lane i pays its proposer (an unslashed source attester
// naming a validator of the sweep): the proposer and the reward
ES_FN bool proposer_share(const Sweep& s, i64 i, i64* proposer, u64* gain) {
  if (s.slashed[i] || !s.src[i]) return false;
  const i64 p = s.best_prop[i];
  if (p < 0 || p >= s.n) return false;
  *proposer = p;
  *gain = static_cast<u64>(rdiv(phase0_base(s, s.eff[i]), s.r_prop_q));
  return true;
}

// The reward numerators' global factors, max(incr, sum) // incr for the
// three sums (a block computes them once, after pass 1)
ES_FN i64 participating_incr(const Sweep& s, int k) {
  const i64 total = static_cast<i64>(s.sums[k]);
  return rdiv(total > s.incr ? total : s.incr, s.r_incr);
}

// Slashings, hysteresis and the registry masks: the tail both families
// share, on the post-deltas balance.  Writes every output but the scores.
ES_FN void finish_lane(const Sweep& s, i64 i, const Lane& l, i64 bal) {
  const i64 eff = s.eff[i];
  const i64 eff_incr = rdiv(eff, s.r_incr);
  const i64 pen = s.electra
      ? mul(eff_incr, s.electra_quot)
      : mul(rdiv(mul(eff_incr, s.adj), s.r_tb), s.incr);
  const bool slash = l.slashed && s.withdrawable[i] == s.slash_epoch;
  bal = max0(sub(bal, slash ? pen : 0));
  const bool move = add(bal, s.hyst_down_amt) < eff ||
                    add(eff, s.hyst_up_amt) < bal;
  i64 new_eff = eff;
  if (move) {
    const i64 floor_bal = mul(rdiv(bal, s.r_incr), s.incr);  // bal - bal % incr
    new_eff = floor_bal < s.max_eff[i] ? floor_bal : s.max_eff[i];
  }
  const u64 act_elig = s.act_elig[i];
  s.out_balances[i] = bal;
  s.out_eff[i] = new_eff;
  s.out_elig_q[i] = act_elig == kFar && eff == s.max_eb;
  s.out_eject[i] = l.active_cur && eff <= s.ejection;
  s.out_ready[i] = act_elig <= s.finalized && s.activation[i] == kFar;
}

// phase0: the lane's own deltas, the proposer gains of pass 1, the floor
// at 0, then the tail; pincr the participating_incr of the three sums
ES_FN void phase0_lane(const Sweep& s, const i64 pincr[3], i64 i) {
  const Lane l = lane_masks(s, i);
  i64 bal = s.balances[i];
  if (s.do_rewards) {
    const i64 eff = s.eff[i];
    const bool unslashed = !l.slashed;
    const bool m[3] = {unslashed && s.src[i], unslashed && s.tgt[i],
                       unslashed && s.head[i]};
    const i64 base = phase0_base(s, eff);
    const i64 prop_reward = rdiv(base, s.r_prop_q);
    i64 rewards = 0;
    i64 penalties = 0;
    for (int k = 0; k < 3; ++k) {
      if (!l.eligible) continue;
      if (m[k]) {
        rewards = add(rewards, s.leak ? base
                      : rdiv(mul(base, pincr[k]), s.r_total_incr));
      } else {
        penalties = add(penalties, base);
      }
    }
    // inclusion-delay rewards: no eligibility filter
    if (m[0])
      rewards = add(rewards, floor_div(sub(base, prop_reward),
                                       s.best_key[i] >> kOrderBits));
    if (s.leak && l.eligible) {
      penalties = add(penalties, sub(mul(s.brpe, base), prop_reward));
      if (!m[1])
        penalties = add(penalties,
                        rdiv(mul(eff, s.finality_delay), s.r_inact_q));
    }
    bal = max0(add(add(bal, sub(rewards, penalties)),
                   static_cast<i64>(s.proposer_gain[i])));
  }
  finish_lane(s, i, l, bal);
}

// altair: scores first (the penalty reads the new score), then each flag's
// delta with its own floor at 0, then the inactivity penalty, then the tail
ES_FN void altair_lane(const Sweep& s, const i64 pincr[3], i64 i) {
  const Lane l = lane_masks(s, i);
  i64 bal = s.balances[i];
  i64 score = s.scores[i];
  if (s.do_rewards) {
    const i64 eff = s.eff[i];
    const i64 part = s.part_prev[i];
    const bool unslashed = !l.slashed;
    const bool tgt_unsl =
        l.active_prev && flag_set(part, s.target_flag) && unslashed;
    if (l.eligible && tgt_unsl) score = sub(score, score < 1 ? score : 1);
    if (l.eligible && !tgt_unsl) score = add(score, s.bias);
    if (!s.leak && l.eligible)
      score = sub(score, score < s.recovery ? score : s.recovery);
    const i64 base = mul(rdiv(eff, s.r_incr), s.base_per_incr);
    for (int k = 0; k < 3; ++k) {
      const bool funsl =
          l.active_prev && flag_set(part, s.flag[k]) && unslashed;
      i64 r = 0;
      if (!s.leak && l.eligible && funsl)
        r = rdiv(mul(mul(base, s.weight[k]), pincr[k]), s.r_incr_wd);
      i64 p = 0;
      if (!s.is_head[k] && l.eligible && !funsl)
        p = rdiv(mul(base, s.weight[k]), s.r_wd);
      bal = max0(sub(add(bal, r), p));
    }
    const i64 pen = rdiv(mul(eff, score), s.r_inact_denom);
    bal = max0(sub(bal, (l.eligible && !tgt_unsl) ? pen : 0));
  }
  s.out_scores[i] = score;
  finish_lane(s, i, l, bal);
}
