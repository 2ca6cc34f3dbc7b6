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
// validator, int64 arithmetic (the lane math and its division by
// reciprocals are in epoch_sweep.cuh, which the tests build on the host),
// and up to two launches a sweep, because the lane math needs three global
// sums first and phase0's final `max(balance + deltas, 0)` needs every
// proposer's gain:
//
//   1. sums and scatter: the effective balances under the three attester
//      masks (phase0: src/tgt/head & ~slashed; altair: active_prev & flag &
//      ~slashed), reduced in each block and added with one 64-bit atomic a
//      block into three slots (skipped in a leak and without rewards: no
//      lane reads them); and, phase0 with rewards, each unslashed source
//      attester's proposer reward into proposer_gain[best_prop].  The
//      scatter is aggregated in the block: each lane adds its reward into
//      a hash table of proposers in shared memory, and the block then
//      issues one global atomic a distinct proposer (a proposer that finds
//      kProbes slots taken goes straight to its global slot).  Integer sums
//      are exact in any order.  Summing a warp's lanes of one proposer
//      first (__match_any_sync, then the lowest lane) cost more than it
//      saved: 0.018883 against 0.017403 ms at 262,144 lanes, 0.064758
//      against 0.061601 at 2^20, and a global atomic a lane without the
//      table 0.097854 ms at 2^20 (scripts/torch_k1_sweep_ab.py on variant
//      sources not kept in the repo, NVIDIA H100 80GB HBM3, 700 W).
//   2. lanes: the whole lane, phase0's with the gains of pass 1.  The
//      values every lane shares are computed once: on the host the
//      hysteresis amounts and electra's quotient (sweep_from_params), in
//      each block the three participating increments.
//
// What bounds it: bytes, then pass 1's scatter.  A phase0 lane reads 76
// bytes (nine int64 columns, four bool columns) and writes 19 (two int64
// lanes, three bool masks); an altair lane reads 73 and writes 27.  The two
// passes read a phase0 lane's columns once in pass 2 and 20 bytes of them
// again in pass 1 (eff, best_prop and the four masks), and clear, scatter
// into and read its proposer gain: about 131 bytes a lane, where the three
// launches before this design read about 160.  The divisions (a dozen a
// phase0 lane, each a call of the 64-bit division routine before) are two
// 64-bit products each: the lane kernel's SASS is 711 instructions, 328 of
// them on the integer pipe and 212 on the FMA pipe, where the three-launch
// design's lane pass and finish were 944 and 615 with I2F, MUFU and CALL of
// that routine (cuobjdump, scripts/torch_k1_sweep_ab.py). Each pass alone
// (the same script, --time-only, on variant sources not kept in the repo,
// with pass 1's first, warp-matched scatter; NVIDIA H100 80GB HBM3, 700 W)
// at 2^20 lanes: pass 2 0.046456 ms against 0.032 by its 103 bytes a lane,
// pass 1 0.021732 ms against about 0.009 by its bytes and the gains' clear;
// without the scatter the sweep took 0.053866 ms against 0.061601 with it.
// Each column is read with consecutive threads on consecutive addresses; the
// only scattered traffic is the proposer atomics, a few a block.

#include <cstdint>
#include <cuda_runtime.h>

#include "epoch_sweep.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned int kSumBlocks = 1056;  // 8 blocks of 256 threads on each of 132 SMs
constexpr int kTable = 128;                // a block's proposer slots
constexpr int kProbes = 8;                 // slots a proposer tries
constexpr i64 kEmpty = -1;

// Add `gain` to proposer p's slot of the block's table (linear probing from
// a hash of p), or to its global slot when kProbes slots are taken.
__device__ __forceinline__ void table_add(i64* keys, u64* vals,
                                          u64* global_gain, i64 p, u64 gain) {
  unsigned int h = static_cast<unsigned int>(
      (static_cast<u64>(p) * 0x9E3779B97F4A7C15ull) >> 57);   // 7 bits
  for (int probe = 0; probe < kProbes; ++probe) {
    const unsigned int slot = (h + probe) & (kTable - 1);
    const i64 k = static_cast<i64>(atomicCAS(
        reinterpret_cast<unsigned long long*>(keys + slot),
        static_cast<unsigned long long>(kEmpty),
        static_cast<unsigned long long>(p)));
    if (k == kEmpty || k == p) {
      atomicAdd(vals + slot, gain);
      return;
    }
  }
  atomicAdd(global_gain + p, gain);
}

// 1. The three masked sums of effective balance and the proposer scatter,
// over a grid-stride loop.
__global__ void __launch_bounds__(kThreads)
sums_scatter_kernel(const Sweep s) {
  __shared__ i64 keys[kTable];
  __shared__ u64 vals[kTable];
  __shared__ u64 part_sums[3][kThreads / 32];
  const bool sums = sweep_sums(s), scatter = sweep_scatters(s);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int t = threadIdx.x; t < kTable; t += kThreads) {
    keys[t] = kEmpty;
    vals[t] = 0;
  }
  __syncthreads();
  u64 acc[3] = {0, 0, 0};
  const i64 stride = static_cast<i64>(gridDim.x) * kThreads;
  for (i64 i = static_cast<i64>(blockIdx.x) * kThreads + threadIdx.x;
       i < s.n; i += stride) {
    if (sums) sums_lane(s, i, acc);
    if (!scatter) continue;
    i64 p;
    u64 gain;
    if (proposer_share(s, i, &p, &gain))
      table_add(keys, vals, s.proposer_gain, p, gain);
  }
  if (scatter) {
    __syncthreads();
    for (int t = threadIdx.x; t < kTable; t += kThreads)
      if (keys[t] != kEmpty) atomicAdd(s.proposer_gain + keys[t], vals[t]);
  }
  if (!sums) return;
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

// 2. The lanes, after the block's three participating increments.
template <bool ALTAIR>
__global__ void __launch_bounds__(kThreads)
lanes_kernel(const Sweep s) {
  __shared__ i64 pincr[3];
  if (threadIdx.x < 3) pincr[threadIdx.x] = participating_incr(s, threadIdx.x);
  __syncthreads();
  const i64 i = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= s.n) return;
  if (ALTAIR) altair_lane(s, pincr, i);
  else phase0_lane(s, pincr, i);
}

}  // namespace

// Plain C entry: `params` is a host array of P_COUNT int64 words (the Param
// slots of epoch_sweep.cuh).  Clears the scratch, then launches the sweep's
// kernels on `stream` one after the other: sums and scatter (unless the
// sweep needs neither: a leak or no rewards without a phase0 scatter),
// then the lanes.  Stores the number of kernels launched in *launched and
// returns the first launch's cudaGetLastError() that is not cudaSuccess,
// as an int, so a refused launch reaches the caller.
extern "C" int epoch_sweep_launch(const int64_t* p, int* launched,
                                  void* stream_ptr) {
  *launched = 0;
  const Sweep s = sweep_from_params(p);
  if (s.n <= 0) return 0;

  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool scatter = sweep_scatters(s);
  cudaError_t err = cudaMemsetAsync(
      s.sums, 0, (3 + (scatter ? s.n : 0)) * sizeof(u64), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int blocks =
      static_cast<unsigned int>((s.n + kThreads - 1) / kThreads);

  if (sweep_sums(s) || scatter) {
    sums_scatter_kernel<<<blocks < kSumBlocks ? blocks : kSumBlocks,
                          kThreads, 0, stream>>>(s);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  if (s.altair)
    lanes_kernel<true><<<blocks, kThreads, 0, stream>>>(s);
  else
    lanes_kernel<false><<<blocks, kThreads, 0, stream>>>(s);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  return 0;
}
