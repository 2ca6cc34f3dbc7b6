// The per-validator epoch sweep for Hopper (sm_90a).
//
// Replaces consensus_specs_tpu/ops/epoch_sweep.py::_build, the XLA program
// that `run_sweep` dispatches once per `process_epoch`: every hot
// per-validator pass of epoch processing over the validator axis, for both
// program families:
//
//   phase0: source/target/head component deltas, inclusion-delay rewards
//           with the proposer scatter, the inactivity-leak penalties;
//   altair: inactivity-score updates, then the three participation-flag
//           delta sets applied in turn, then the inactivity penalty
//           (`electra` only switches the slashings form);
//   both:   the slashings penalty, effective-balance hysteresis and the
//           three registry-eligibility masks.
//
// It computes what the XLA program computes, lane for lane, and is held
// bit for bit against the plain torch version (ops/epoch_sweep.py
// plain_sweep).  It is not a copy of the XLA program's blocks: one thread a
// validator, int64 arithmetic, and up to three launches a sweep, because
// the lane math needs three global sums first and phase0's final
// `max(balance + deltas, 0)` needs the proposer scatter to have finished:
//
//   1. masked sums: the effective balances under the three attester masks
//      (phase0: src/tgt/head & ~slashed; altair: active_prev & flag &
//      ~slashed), reduced in each block and added with one 64-bit atomic a
//      block into three slots.  Integer sums are exact in any order.
//      Skipped in a leak and when there are no rewards (no lane reads them).
//   2. lane pass: phase0 writes each lane's balance plus its own rewards
//      minus its penalties, and adds each unslashed source attester's
//      proposer reward into proposer_gain[best_prop] with a 64-bit atomic
//      (about 32 proposers take every attester's atomic: correct, and left
//      to contend); altair computes the whole lane.
//   3. phase0 finish: max(net + proposer_gain, 0), then the shared tail
//      (slashings, hysteresis, masks).
//
// What bounds it: bytes.  A phase0 lane reads 76 bytes (nine int64
// columns, four bool columns) and writes 19 (two int64 lanes, three bool
// masks); an altair lane reads 73 and writes 27.  About 30 int64
// operations a lane (a dozen of them divisions, a few tens of 32-bit
// instructions each) stay under the memory time.  Each column is read with
// consecutive threads on consecutive addresses; the only scattered traffic
// is the proposer atomics, which hit a few L2 lines.
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
// so the wrap never fires on real states, and where it would the kernel
// still agrees with the reference.
//
// Epochs are uint64 with FAR_FUTURE_EPOCH = 2^64 - 1; they arrive as int64
// bit patterns and are compared as unsigned long long.  Bool columns arrive
// as torch.bool and are read as uint8.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;
typedef long long i64;

constexpr int kOrderBits = 24;  // ops/epoch_sweep.py ORDER_BITS
constexpr u64 kFar = ~0ull;     // FAR_FUTURE_EPOCH
constexpr int kThreads = 256;
constexpr unsigned int kSumBlocks = 1056;  // 8 blocks of 256 threads on each of 132 SMs

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
  P_COUNT
};

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
  bool do_rewards, leak, electra;
  u64 cur, prev, finalized, slash_epoch;
  i64 tb, adj, sqrt_tb, finality_delay, base_per_incr, bias, recovery,
      inact_denom;
  i64 incr, max_eb, ejection, hyst_q, hyst_down, hyst_up, brf, brpe, prop_q,
      inact_q, wd;
  int target_flag;
  int flag[3];
  i64 weight[3];
  bool is_head[3];
};

// int64 arithmetic with numpy's semantics: wrapping +, -, *; floor //, %.
__device__ __forceinline__ i64 add(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) + static_cast<u64>(b));
}
__device__ __forceinline__ i64 sub(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) - static_cast<u64>(b));
}
__device__ __forceinline__ i64 mul(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) * static_cast<u64>(b));
}
__device__ __forceinline__ i64 floor_div(i64 a, i64 b) {
  const i64 q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ i64 floor_mod(i64 a, i64 b) {
  return sub(a, mul(floor_div(a, b), b));
}
__device__ __forceinline__ i64 max0(i64 a) { return a > 0 ? a : 0; }

struct Lane {
  bool slashed, active_prev, active_cur, eligible;
};

__device__ __forceinline__ Lane lane_masks(const Sweep& s, i64 i) {
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

__device__ __forceinline__ bool flag_set(i64 part, int flag) {
  return ((part >> flag) & 1) == 1;
}

// Slashings, hysteresis and the registry masks: the tail both families
// share, on the post-deltas balance.  Writes every output but the scores.
__device__ __forceinline__ void finish_lane(const Sweep& s, i64 i,
                                            const Lane& l, i64 bal) {
  const i64 eff = s.eff[i];
  const i64 eff_incr = floor_div(eff, s.incr);
  const i64 pen = s.electra
      ? mul(eff_incr, floor_div(s.adj, floor_div(s.tb, s.incr)))
      : mul(floor_div(mul(eff_incr, s.adj), s.tb), s.incr);
  const bool slash = l.slashed && s.withdrawable[i] == s.slash_epoch;
  bal = max0(sub(bal, slash ? pen : 0));
  const i64 h = floor_div(s.incr, s.hyst_q);
  const bool move = add(bal, mul(h, s.hyst_down)) < eff ||
                    add(eff, mul(h, s.hyst_up)) < bal;
  i64 new_eff = eff;
  if (move) {
    const i64 floor_bal = sub(bal, floor_mod(bal, s.incr));
    new_eff = floor_bal < s.max_eff[i] ? floor_bal : s.max_eff[i];
  }
  const u64 act_elig = s.act_elig[i];
  s.out_balances[i] = bal;
  s.out_eff[i] = new_eff;
  s.out_elig_q[i] = act_elig == kFar && eff == s.max_eb;
  s.out_eject[i] = l.active_cur && eff <= s.ejection;
  s.out_ready[i] = act_elig <= s.finalized && s.activation[i] == kFar;
}

// 1. The three masked sums of effective balance.
__global__ void __launch_bounds__(kThreads)
sums_kernel(const Sweep s, bool altair) {
  u64 acc[3] = {0, 0, 0};
  const i64 stride = static_cast<i64>(gridDim.x) * blockDim.x;
  for (i64 i = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < s.n; i += stride) {
    if (s.slashed[i]) continue;
    const u64 eff = static_cast<u64>(s.eff[i]);
    if (altair) {
      const u64 activation = s.activation[i];
      if (!(activation <= s.prev && s.prev < s.exit_epoch[i])) continue;
      const i64 part = s.part_prev[i];
      for (int k = 0; k < 3; ++k)
        if (flag_set(part, s.flag[k])) acc[k] += eff;
    } else {
      if (s.src[i]) acc[0] += eff;
      if (s.tgt[i]) acc[1] += eff;
      if (s.head[i]) acc[2] += eff;
    }
  }
  __shared__ u64 part_sums[3][kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = 0; k < 3; ++k) {
    u64 v = acc[k];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part_sums[k][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    u64 v = 0;
    for (int w = 0; w < kThreads / 32; ++w) v += part_sums[threadIdx.x][w];
    if (v) atomicAdd(s.sums + threadIdx.x, v);
  }
}

// The reward numerator's global factor: max(incr, sum) // incr.
__device__ __forceinline__ i64 participating_incr(const Sweep& s, int k) {
  const i64 total = static_cast<i64>(s.sums[k]);
  return floor_div(total > s.incr ? total : s.incr, s.incr);
}

// 2a. phase0 lane pass: the lane's own deltas and the proposer scatter.
__global__ void __launch_bounds__(kThreads)
phase0_lanes_kernel(const Sweep s) {
  const i64 i = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= s.n) return;
  const Lane l = lane_masks(s, i);
  const i64 eff = s.eff[i];
  const bool unslashed = !l.slashed;
  const bool m[3] = {unslashed && s.src[i], unslashed && s.tgt[i],
                     unslashed && s.head[i]};
  const i64 base = floor_div(floor_div(mul(eff, s.brf), s.sqrt_tb), s.brpe);
  const i64 prop_reward = floor_div(base, s.prop_q);
  const i64 total_incr = floor_div(s.tb, s.incr);
  i64 rewards = 0;
  i64 penalties = 0;
  for (int k = 0; k < 3; ++k) {
    if (!l.eligible) continue;
    if (m[k]) {
      rewards = add(rewards, s.leak ? base
                    : floor_div(mul(base, participating_incr(s, k)), total_incr));
    } else {
      penalties = add(penalties, base);
    }
  }
  // inclusion-delay rewards: no eligibility filter
  if (m[0]) {
    const i64 delay = s.best_key[i] >> kOrderBits;
    rewards = add(rewards, floor_div(sub(base, prop_reward), delay));
    const i64 proposer = s.best_prop[i];
    if (proposer >= 0 && proposer < s.n)
      atomicAdd(s.proposer_gain + proposer, static_cast<u64>(prop_reward));
  }
  if (s.leak && l.eligible) {
    penalties = add(penalties, sub(mul(s.brpe, base), prop_reward));
    if (!m[1])
      penalties = add(penalties,
                      floor_div(mul(eff, s.finality_delay), s.inact_q));
  }
  s.out_balances[i] = add(s.balances[i], sub(rewards, penalties));
}

// 3. phase0 finish: add the proposer gains, floor at 0, then the tail.
__global__ void __launch_bounds__(kThreads)
phase0_finish_kernel(const Sweep s) {
  const i64 i = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= s.n) return;
  const Lane l = lane_masks(s, i);
  const i64 bal = s.do_rewards
      ? max0(add(s.out_balances[i],
                 static_cast<i64>(s.proposer_gain[i])))
      : s.balances[i];
  finish_lane(s, i, l, bal);
}

// 2b. altair: the whole lane.  Scores first (the penalty reads the new
// score), then each flag's delta with its own floor at 0, then the
// inactivity penalty, then the tail.
__global__ void __launch_bounds__(kThreads)
altair_kernel(const Sweep s) {
  const i64 i = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= s.n) return;
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
    const i64 active_incr = floor_div(s.tb, s.incr);
    const i64 base = mul(floor_div(eff, s.incr), s.base_per_incr);
    for (int k = 0; k < 3; ++k) {
      const bool funsl =
          l.active_prev && flag_set(part, s.flag[k]) && unslashed;
      i64 r = 0;
      if (!s.leak && l.eligible && funsl)
        r = floor_div(mul(mul(base, s.weight[k]), participating_incr(s, k)),
                 mul(active_incr, s.wd));
      i64 p = 0;
      if (!s.is_head[k] && l.eligible && !funsl)
        p = floor_div(mul(base, s.weight[k]), s.wd);
      bal = max0(sub(add(bal, r), p));
    }
    const i64 pen = floor_div(mul(eff, score), s.inact_denom);
    bal = max0(sub(bal, (l.eligible && !tgt_unsl) ? pen : 0));
  }
  s.out_scores[i] = score;
  finish_lane(s, i, l, bal);
}

template <typename T>
T* ptr(const int64_t* p, int slot) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(p[slot]));
}

}  // namespace

// Plain C entry: `params` is a host array of P_COUNT int64 words (the Param
// slots above).  Clears the scratch, then launches the sweep's kernels on
// `stream` one after the other: sums (unless in a leak or without
// rewards), then altair's lane kernel, or phase0's lane pass (with
// rewards) and finish.  Stores the number of kernels launched in
// *launched and returns the first launch's cudaGetLastError() that is not
// cudaSuccess, as an int, so a refused launch reaches the caller.
extern "C" int epoch_sweep_launch(const int64_t* p, int* launched,
                                  void* stream_ptr) {
  *launched = 0;
  Sweep s;
  s.eff = ptr<const i64>(p, P_EFF);
  s.slashed = ptr<const uint8_t>(p, P_SLASHED);
  s.activation = ptr<const u64>(p, P_ACTIVATION);
  s.exit_epoch = ptr<const u64>(p, P_EXIT_EPOCH);
  s.act_elig = ptr<const u64>(p, P_ACT_ELIG);
  s.withdrawable = ptr<const u64>(p, P_WITHDRAWABLE);
  s.balances = ptr<const i64>(p, P_BALANCES);
  s.max_eff = ptr<const i64>(p, P_MAX_EFF);
  s.src = ptr<const uint8_t>(p, P_SRC);
  s.tgt = ptr<const uint8_t>(p, P_TGT);
  s.head = ptr<const uint8_t>(p, P_HEAD);
  s.best_key = ptr<const i64>(p, P_BEST_KEY);
  s.best_prop = ptr<const i64>(p, P_BEST_PROP);
  s.part_prev = ptr<const i64>(p, P_PART_PREV);
  s.scores = ptr<const i64>(p, P_SCORES);
  s.out_balances = ptr<i64>(p, P_OUT_BALANCES);
  s.out_scores = ptr<i64>(p, P_OUT_SCORES);
  s.out_eff = ptr<i64>(p, P_OUT_EFF);
  s.out_elig_q = ptr<uint8_t>(p, P_OUT_ELIG_Q);
  s.out_eject = ptr<uint8_t>(p, P_OUT_EJECT);
  s.out_ready = ptr<uint8_t>(p, P_OUT_READY);
  u64* scratch = ptr<u64>(p, P_SCRATCH);
  s.sums = scratch;
  s.proposer_gain = scratch + 3;
  s.n = p[P_N];
  const bool altair = p[P_ALTAIR] != 0;
  s.do_rewards = p[P_DO_REWARDS] != 0;
  s.leak = p[P_LEAK] != 0;
  s.electra = p[P_ELECTRA] != 0;
  s.cur = static_cast<u64>(p[P_CUR]);
  s.prev = static_cast<u64>(p[P_PREV]);
  s.finalized = static_cast<u64>(p[P_FINALIZED]);
  s.slash_epoch = static_cast<u64>(p[P_SLASH_EPOCH]);
  s.tb = p[P_TB];
  s.adj = p[P_ADJ];
  s.sqrt_tb = p[P_SQRT_TB];
  s.finality_delay = p[P_FINALITY_DELAY];
  s.base_per_incr = p[P_BASE_PER_INCR];
  s.bias = p[P_BIAS];
  s.recovery = p[P_RECOVERY];
  s.inact_denom = p[P_INACT_DENOM];
  s.incr = p[P_INCR];
  s.max_eb = p[P_MAX_EB];
  s.ejection = p[P_EJECTION];
  s.hyst_q = p[P_HYST_Q];
  s.hyst_down = p[P_HYST_DOWN];
  s.hyst_up = p[P_HYST_UP];
  s.brf = p[P_BRF];
  s.brpe = p[P_BRPE];
  s.prop_q = p[P_PROP_Q];
  s.inact_q = p[P_INACT_Q];
  s.wd = p[P_WD];
  s.target_flag = static_cast<int>(p[P_TARGET_FLAG]);
  for (int k = 0; k < 3; ++k) {
    s.flag[k] = static_cast<int>(p[P_FLAG0 + 3 * k]);
    s.weight[k] = p[P_WEIGHT0 + 3 * k];
    s.is_head[k] = p[P_IS_HEAD0 + 3 * k] != 0;
  }
  if (s.n <= 0) return 0;

  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool scatter = !altair && s.do_rewards;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (3 + (scatter ? s.n : 0)) * sizeof(u64), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int blocks =
      static_cast<unsigned int>((s.n + kThreads - 1) / kThreads);

  if (s.do_rewards && !s.leak) {
    sums_kernel<<<blocks < kSumBlocks ? blocks : kSumBlocks, kThreads, 0,
                  stream>>>(s, altair);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  if (altair) {
    altair_kernel<<<blocks, kThreads, 0, stream>>>(s);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ++*launched;
    return 0;
  }
  if (s.do_rewards) {
    phase0_lanes_kernel<<<blocks, kThreads, 0, stream>>>(s);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  phase0_finish_kernel<<<blocks, kThreads, 0, stream>>>(s);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  return 0;
}
