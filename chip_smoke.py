#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Drives the port's three paths on the card, the per-slot BeaconState root
(slice 1), incremental re-roots (slice 2) and the phase0 epoch transition
(slice 3), and holds every kernel of those paths against its plain PyTorch
version:

1. device: requires a CUDA card and prints its name and power limit;
2. build: builds the three kernels, SHA-256 pair-hash and gather-hash and
   the epoch sweep, from the repository's sources;
3. kernel: the pair-hash kernel against the plain torch version on the card,
   bit for bit, at 1, 255, 256, 257, 65,537, 2**17 and 2**20 pairs, with rows
   checked against hashlib, and the times of kernel (replayed from a CUDA
   graph, and launched eagerly), plain version and host hashlib;
4. main path: a mainnet-preset phase0 BeaconState of 262,144 validators, made
   from a seed, advanced from slot 97 to 99 with `process_slots` on the card,
   and the same steps on a copy with host hashing; the post-states must be
   equal, and every slot must have launched the pair-hash kernel;
5. incremental: the same seeded state with incremental mode on: (a) the
   cache build (process_slots 97 -> 98, one fused sweep on the gather-hash
   kernel), (b) per-slot diff re-roots to slot 101, (c) an epoch-shaped diff
   (every balance, through bulk_set_basic), (d) two block-shaped diffs at a
   bulk threshold of 1.  Every root must equal the full-rebuild oracle with
   host hashing, and the root at slot 101 that of a copy advanced with
   incremental mode off; (a), (c) and (d) must launch the kernel;
6. gather kernel: the gather-hash kernel against the plain torch version on
   the card, bit for bit, for two rounds with cross-round indices at 1, 255,
   257, 65,537 and 2**17 pairs a round and at the cache build's largest
   round, with rows checked against hashlib, and its times;
7. epoch: the same seeded state at slot 127 with pending attestations and
   registry edge cases (`epoch_state`), incremental mode on and the sweep's
   guard at rate 1, advanced to slot 128 with `process_slots`: one sweep
   dispatch on the epoch-sweep kernel, every lane held against the plain
   version, and the root at slot 128 equal to the host-hashed oracle and to
   the JAX package's (POST_EPOCH_ROOT_128); prints the seconds of each part
   of the epoch;
8. epoch kernel: the epoch-sweep kernel against the plain torch version on
   the card, bit for bit on every output lane, for both families, with and
   without a leak, without rewards and with electra's slashings, at 1, 255,
   257, 65,537, 2**18 and 2**20 lanes, and its times.

Each phase prints its seconds.  The second-to-last line is a JSON object with
one entry per kernel; the last line is {"ok": true, "device": {...}}.  Any
failure raises and exits non-zero.  There is no CPU path.
"""
import hashlib
import json
import math
import random
import subprocess
import time

import numpy as np
import torch

import consensus_specs_tpu_torch as port
from consensus_specs_tpu_torch.ops import (
    cuda_build, epoch_sweep, epoch_sweep_cuda, sha256, sha256_cuda)
from consensus_specs_tpu_torch.sigpipe import METRICS
from consensus_specs_tpu_torch.specs import epoch_fast, get_spec
from consensus_specs_tpu_torch.ssz import incremental, merkle

SEED = 2026
N_VALIDATORS = 1 << 18          # bench.py EPOCH_VALIDATORS
START_SLOT = 97                 # no epoch boundary up to slot 127
END_SLOT = 99                   # the main path: two process_slot calls
INC_END_SLOT = 101              # the incremental path: four
EPOCH_SLOT = 127                # the epoch path: process_slots 127 -> 128
# the post-state root at slot 101 of the seeded state, advanced with full
# rebuilds (chip_smoke.py's four-slot main path before incremental re-roots)
FULL_REBUILD_ROOT_101 = (
    "9d5159b701792b2ec49b6180984c36ecd7bd55e18b4e3dbdd298da57be0366b6")
# the JAX package's root at slot 128 of epoch_state(spec, N_VALIDATORS)
# after process_slots(state, 128), on the CPU
# (scripts/torch_epoch_reference_root.py)
POST_EPOCH_ROOT_128 = (
    "68891d02776f70579e92d08fa22c5e02bd4440b3f3761ca435846dc70d13f648")
KERNEL_SIZES = (1, 255, 256, 257, 65537, 1 << 17, 1 << 20)
TIMED_SIZES = (1 << 17, 1 << 20)
MAIN_PATH_PAIRS = 1 << 17       # the largest level of the main path
GATHER_SIZES = (1, 255, 257, 65537, 1 << 17)  # and the cache build's largest
COMMITTEE = 128                 # bench.py COMMITTEE: balances a block credits
EPOCH_KERNEL_SIZES = (1, 255, 257, 65537, 1 << 18, 1 << 20)
EPOCH_TIMED = 1 << 18           # the epoch path's sweep
EPOCH_PROPOSERS = 32            # a previous epoch's block proposers
# name: (family, leak, do_rewards, electra)
EPOCH_CASES = {
    "phase0": ("phase0", False, True, False),
    "phase0 leak": ("phase0", True, True, False),
    "phase0 no rewards": ("phase0", False, False, False),
    "altair": ("altair", False, True, False),
    "altair leak": ("altair", True, True, False),
    "altair no rewards": ("altair", False, False, False),
    "electra": ("altair", False, True, True),
}
# int64 operations of a phase0 sweep lane in the reference's formula (the
# masks, base reward, three components, inclusion delay, slashings,
# hysteresis and registry masks), each counted as one 32-bit instruction:
# a lower bound, since an int64 multiply or division takes several
EPOCH_OPS_PER_LANE = 60

# H100 SXM data sheet: HBM3 at 3.35 TB/s.  No instruction mix issues faster
# than 128 lanes per SM per clock (four schedulers, one 32-lane warp
# instruction a clock each; the data sheet's 67 TFLOP/s float32 is this rate
# with an FMA counted as two).  SM count and max clock are read from the card.
MEMORY_BYTES_PER_S = 3.35e12
SCHEDULER_LANES_PER_SM_PER_CLOCK = 128
# 32-bit instructions one pair needs at the least, with the three-input
# forms Hopper has (LOP3 for any logic of three words, IADD3 for a sum of
# three, SHF for a rotate): a round is 14 (Sigma1 and Sigma0 3 SHF + 1 LOP3
# each, Ch 1, Maj 1, T1 2 IADD3, e 1, a 1), a schedule word 10 (sigma0 and
# sigma1 3 shifts + 1 LOP3 each, 2 IADD3), a block's feed-forward 8.  The
# message block has 64 rounds and 48 schedule words; the pad block's schedule
# is constant and needs no instruction.
OPS_PER_PAIR = (64 * 14 + 48 * 10 + 8) + (64 * 14 + 8)
BYTES_PER_PAIR = 64 + 32
# a gathered pair also reads its two int32 row indices
GATHER_BYTES_PER_PAIR = BYTES_PER_PAIR + 8


def phase(name):
    """Decorator: run the phase and print its seconds on a line of its own."""
    def wrap(fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            print(f"phase {name}: {time.perf_counter() - t0:.6f} s",
                  flush=True)
            return out
        return run
    return wrap


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip smoke failed: {what}")


def nvidia_smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
         "--id=0"], check=True, capture_output=True, text=True,
        timeout=60).stdout.strip()


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() on the card, by CUDA events, after warm-up."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Mean milliseconds of fn() on the card with no host launch path in
    the way: `reps` calls captured in one CUDA graph, replayed between two
    events (the kernel's own time; cuda_ms of a small kernel measures the
    host's launch path when that is the slower)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def seeded_chunks(rng, n_pairs):
    words = rng.integers(0, 2**32, size=(2 * n_pairs, 8), dtype=np.uint32)
    words[0, :3] = (0x00000000, 0xFFFFFFFF, 0x80000000)  # int32 sign edges
    return words


@phase("device")
def device_phase():
    check(torch.cuda.is_available(), "no CUDA card (torch.cuda.is_available())")
    card = nvidia_smi("name,power.limit")
    print(card)
    props = torch.cuda.get_device_properties(0)
    max_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{props.multi_processor_count} SMs, max SM clock {max_mhz} MHz")
    port.set_device("cuda")
    return card, props.multi_processor_count, max_mhz


@phase("build")
def build_phase():
    cuda_build.build()
    print(f"sha256_pairs, sha256_gather and epoch_sweep built by "
          f"{cuda_build.build_route} into {cuda_build.BUILD_DIR}")


def bound(n_pairs, bytes_per_pair, n_sms, max_mhz):
    """(bound_ms, bound_by, op_ms, byte_ms) of n_pairs 2-to-1 hashes."""
    op_ms = OPS_PER_PAIR * n_pairs / (
        n_sms * SCHEDULER_LANES_PER_SM_PER_CLOCK * max_mhz * 1e6) * 1e3
    byte_ms = bytes_per_pair * n_pairs / MEMORY_BYTES_PER_S * 1e3
    return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms
            else "bytes", op_ms, byte_ms)


@phase("kernel")
def kernel_phase(n_sms, max_mhz):
    rng = np.random.default_rng(SEED)
    max_err = 0
    times = {}
    for n in KERNEL_SIZES:
        words = seeded_chunks(rng, n)
        x = sha256.words_from_numpy(words, "cuda")
        got = sha256_cuda.hash_pairs_cuda(x)
        plain = sha256.hash_pairs(x)
        torch.cuda.synchronize()
        err = int((got.long() - plain.long()).abs().max())
        max_err = max(max_err, err)
        check(got.shape == (n, 8) and err == 0,
              f"kernel != plain version at {n} pairs (max |diff| {err})")
        data = words.astype(">u4").tobytes()
        digests = sha256.words_to_bytes(got)
        rows = sorted({0, n // 2, n - 1,
                       *rng.integers(0, n, 16).tolist()})
        for i in rows:
            check(digests[32 * i:32 * (i + 1)]
                  == hashlib.sha256(data[64 * i:64 * (i + 1)]).digest(),
                  f"kernel row {i} of {n} != hashlib")
        print(f"{n} pairs: kernel == plain bit for bit, "
              f"{len(rows)} rows == hashlib")
        if n in TIMED_SIZES:
            kernel_ms = graph_ms(lambda: sha256_cuda.hash_pairs_cuda(x), 50)
            eager_ms = cuda_ms(lambda: sha256_cuda.hash_pairs_cuda(x), 50)
            plain_ms = cuda_ms(lambda: sha256.hash_pairs(x), 3)
            t0 = time.perf_counter()
            for i in range(n):
                hashlib.sha256(data[64 * i:64 * (i + 1)]).digest()
            host_s = time.perf_counter() - t0
            bound_ms, bound_by, op_ms, byte_ms = bound(
                n, BYTES_PER_PAIR, n_sms, max_mhz)
            times[n] = dict(ms=kernel_ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            host_ms=host_s * 1e3)
            print(f"{n} pairs: kernel {kernel_ms:.6f} ms "
                  f"({n / kernel_ms * 1e3:.0f} pairs/s; {eager_ms:.6f} ms "
                  f"a call launched eagerly), plain torch "
                  f"{plain_ms:.6f} ms, host hashlib {host_s * 1e3:.6f} ms "
                  f"({n / host_s:.0f} pairs/s); bound {op_ms:.6f} ms by "
                  f"{OPS_PER_PAIR * n} operations, {byte_ms:.6f} ms by "
                  f"{BYTES_PER_PAIR * n} bytes; no PyTorch call computes "
                  f"SHA-256, so no library time")
    return max_err, times


def seeded_state(spec, n, slot=START_SLOT):
    """Mainnet-preset phase0 state shaped like bench.py's epoch state:
    n active validators with synthetic keys, balances around 32 ETH, and
    seeded roots, mixes and slashings; at `slot` with an empty header
    state root."""
    rng = np.random.default_rng(SEED)
    max_eb = int(spec.MAX_EFFECTIVE_BALANCE)
    pubkeys = rng.bytes(48 * n)
    credentials = rng.bytes(20 * n)

    def chunks(count):
        data = rng.bytes(32 * count)
        return [data[32 * i:32 * (i + 1)] for i in range(count)]
    state = spec.BeaconState(
        genesis_time=spec.config.MIN_GENESIS_TIME,
        genesis_validators_root=rng.bytes(32),
        randao_mixes=chunks(spec.EPOCHS_PER_HISTORICAL_VECTOR),
        block_roots=chunks(spec.SLOTS_PER_HISTORICAL_ROOT),
        state_roots=chunks(spec.SLOTS_PER_HISTORICAL_ROOT),
        slashings=[int(x) for x in rng.integers(
            0, 2**40, spec.EPOCHS_PER_SLASHINGS_VECTOR)])
    state.validators = [
        spec.Validator(
            pubkey=pubkeys[48 * i:48 * (i + 1)],
            withdrawal_credentials=(b"\x01" + b"\x00" * 11
                                    + credentials[20 * i:20 * (i + 1)]),
            effective_balance=max_eb,
            activation_epoch=0,
            activation_eligibility_epoch=0,
            exit_epoch=spec.FAR_FUTURE_EPOCH,
            withdrawable_epoch=spec.FAR_FUTURE_EPOCH)
        for i in range(n)]
    state.balances = [int(b) for b in max_eb + rng.integers(-10**9, 10**9, n)]
    state.slot = slot
    state.latest_block_header = spec.BeaconBlockHeader(
        slot=slot - 1, proposer_index=int(rng.integers(0, n)),
        parent_root=rng.bytes(32), body_root=rng.bytes(32))
    return state


def epoch_state(spec, n):
    """seeded_state at EPOCH_SLOT, the last slot of epoch 3, with what a
    phase0 epoch transition reads (seeded from SEED + 3, so seeded_state's
    draws are unchanged):

    - 8 previous-epoch PendingAttestations over 4 committees, each
      committee attested twice with different inclusion delays and
      proposers; one has a wrong target root and one a wrong head root;
      about 90% of the aggregation bits set;
    - 4 current-epoch attestations with the right target, for
      justification;
    - 2 slashed validators withdrawable at epoch 3 + 4096 (inside the
      slashings window), 1 at the ejection balance, 1 with
      activation_eligibility_epoch FAR (the eligibility queue) and 1 with
      activation_epoch FAR and eligibility 0 (the activation queue).

    Committees are sized from the active count alone (the spec's
    compute_committee slices), so the bits need no committee lookup."""
    state = seeded_state(spec, n, EPOCH_SLOT)
    rng = np.random.default_rng(SEED + 3)
    far = int(spec.FAR_FUTURE_EPOCH)
    cur = EPOCH_SLOT // int(spec.SLOTS_PER_EPOCH)
    for i in (10, 11):
        v = state.validators[i]
        v.slashed = True
        v.exit_epoch = cur + 5
        v.withdrawable_epoch = cur + int(spec.EPOCHS_PER_SLASHINGS_VECTOR) // 2
    state.validators[12].effective_balance = int(spec.config.EJECTION_BALANCE)
    state.balances[12] = int(spec.config.EJECTION_BALANCE)
    state.validators[13].activation_eligibility_epoch = far
    state.validators[14].activation_epoch = far

    slots_per_epoch = int(spec.SLOTS_PER_EPOCH)
    active = n - 1                     # validator 14 is not active yet
    per_slot = max(1, min(int(spec.MAX_COMMITTEES_PER_SLOT),
                          active // slots_per_epoch
                          // int(spec.TARGET_COMMITTEE_SIZE)))
    count = per_slot * slots_per_epoch

    def attestation(slot, index, target_ok, head_ok, delay):
        k = (slot % slots_per_epoch) * per_slot + index
        size = active * (k + 1) // count - active * k // count
        epoch = slot // slots_per_epoch
        target = (bytes(spec.get_block_root(state, epoch)) if target_ok
                  else rng.bytes(32))
        head = (bytes(state.block_roots[slot % spec.SLOTS_PER_HISTORICAL_ROOT])
                if head_ok else rng.bytes(32))
        return spec.PendingAttestation(
            aggregation_bits=[bool(b) for b in rng.random(size) < 0.9],
            data=spec.AttestationData(
                slot=slot, index=index, beacon_block_root=head,
                target=spec.Checkpoint(epoch=epoch, root=target)),
            inclusion_delay=delay,
            proposer_index=int(rng.integers(0, n)))

    prev_start = (cur - 1) * slots_per_epoch
    committees = [(prev_start + 3, 0), (prev_start + 9, per_slot - 1),
                  (prev_start + 17, 1 % per_slot), (prev_start + 30, 0)]
    flags = [(True, True), (False, True), (True, False), (True, True)]
    state.previous_epoch_attestations = [
        attestation(slot, index, *flags[j] if copy == 0 else (True, True),
                    delay=1 + copy + j)
        for j, (slot, index) in enumerate(committees) for copy in (0, 1)]
    cur_start = cur * slots_per_epoch
    state.current_epoch_attestations = [
        attestation(cur_start + s, 0, True, True, delay=1)
        for s in (2, 7, 11, 20)]
    return state


class TimedDeviceHashers:
    """Installs the device hashers with a host clock around each call, so a
    slot's time splits into the card path (upload, kernels, download) and
    everything else (hashlib, SSZ views, Python)."""

    def __init__(self):
        self.seconds = 0.0
        merkle.set_bulk_level_hasher(self._timed(merkle.device_hash_level))
        merkle.set_subtree_hasher(self._timed(merkle.device_subtree_root))

    def _timed(self, fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            self.seconds += time.perf_counter() - t0
            return out
        return run


def run_slots(spec, state, label, hashers=None):
    """process_slots one slot at a time; per-slot seconds, launches and
    pairs on each side, and the seconds inside the device hashers."""
    per_slot = []
    for slot in range(START_SLOT, END_SLOT):
        launches = sha256_cuda.hash_pairs_cuda.launches
        pairs = dict(merkle.stats)
        in_hashers = hashers.seconds if hashers else 0.0
        t0 = time.perf_counter()
        spec.process_slots(state, slot + 1)
        torch.cuda.synchronize()
        row = dict(slot=slot, s=time.perf_counter() - t0,
                   hashers_s=(hashers.seconds if hashers else 0.0)
                   - in_hashers,
                   launches=sha256_cuda.hash_pairs_cuda.launches - launches,
                   device_pairs=merkle.stats["device_pairs"]
                   - pairs["device_pairs"],
                   host_pairs=merkle.stats["host_pairs"] - pairs["host_pairs"])
        print(f"{label} slot {slot}: {row['s']:.6f} s, of which "
              f"{row['hashers_s']:.6f} s in the device hashers; "
              f"{row['launches']} kernel launches, {row['device_pairs']} "
              f"pairs on the card, {row['host_pairs']} pairs with hashlib",
              flush=True)
        per_slot.append(row)
    return per_slot


@phase("main path")
def main_path_phase():
    spec = get_spec("phase0", "mainnet")
    t0 = time.perf_counter()
    state = seeded_state(spec, N_VALIDATORS)
    host_state = state.copy()
    print(f"state of {N_VALIDATORS} validators built and copied in "
          f"{time.perf_counter() - t0:.6f} s")

    hashers = TimedDeviceHashers()
    sha256_cuda.hash_pairs_cuda.launches = 0
    sha256_cuda.hash_gather_pairs_cuda.launches = 0
    merkle.reset_stats()
    card = run_slots(spec, state, "card", hashers)
    launches = sha256_cuda.hash_pairs_cuda.launches
    print(f"main path: {launches} sha256_pairs launches, "
          f"{sha256_cuda.hash_gather_pairs_cuda.launches} sha256_gather "
          f"launches (incremental mode off)")
    check(all(r["launches"] > 0 for r in card),
          "a slot on the card launched no kernel")

    merkle.use_host_hashing()
    host = run_slots(spec, host_state, "host")
    check(sha256_cuda.hash_pairs_cuda.launches == launches,
          "the host reference launched the kernel")
    host_root = bytes(spec.hash_tree_root(host_state))
    merkle.use_device_hashing()
    card_root = bytes(spec.hash_tree_root(state))
    check(state.encode_bytes() == host_state.encode_bytes(),
          "post-state bytes differ between card and host hashing")
    check(card_root == host_root,
          f"post-state root {card_root.hex()} != host {host_root.hex()}")
    print(f"post-state root at slot {END_SLOT}: {card_root.hex()} "
          f"(card == host)")
    mean = lambda rows, k: sum(r[k] for r in rows) / len(rows)  # noqa: E731
    print(f"per slot: card {mean(card, 's'):.6f} s (device hashers "
          f"{mean(card, 'hashers_s'):.6f} s), host {mean(host, 's'):.6f} s, "
          f"{mean(card, 'launches'):.1f} launches, "
          f"{mean(card, 'device_pairs'):.0f} pairs on the card and "
          f"{mean(card, 'host_pairs'):.0f} with hashlib")
    return launches


class FusedRecorder:
    """Wraps ops.sha256.fused_rounds, which the incremental sweep looks up
    at every call, to record each fused sweep: its round sizes, literals,
    pool hits and host seconds (upload, launches, download; the call ends
    in its download, so the host clock covers the card's work)."""

    def __init__(self):
        self.sweeps = []
        self._fused_rounds = sha256.fused_rounds
        sha256.fused_rounds = self._run

    def _run(self, literals, rounds, stats=None):
        t0 = time.perf_counter()
        out = self._fused_rounds(literals, rounds, stats)
        self.sweeps.append(dict(
            rounds=len(rounds), largest=max(len(il) for il, _ir in rounds),
            pairs=sum(len(il) for il, _ir in rounds),
            literals=len(literals) // 32, uploaded=stats["uploaded"],
            skipped=stats["skipped"], s=time.perf_counter() - t0))
        return out

    def close(self):
        sha256.fused_rounds = self._fused_rounds


def host_oracle(state):
    """incremental.oracle_root with host hashing, then the hashers as they
    were."""
    saved = (merkle._bulk_hash_level, merkle._bulk_threshold,
             merkle._subtree_hasher, merkle._subtree_threshold)
    merkle.use_host_hashing()
    try:
        return incremental.oracle_root(state)
    finally:
        merkle.set_bulk_level_hasher(saved[0], saved[1])
        merkle.set_subtree_hasher(saved[2], saved[3])


def inc_step(label, fn, rec, state):
    """Run one step of the incremental path: fn() mutates the state and
    returns its root.  Prints seconds, launches, pairs on each side and the
    step's fused sweeps; checks that nothing ran on the plain versions and
    that the root equals the host-hashed full-rebuild oracle."""
    gather = sha256_cuda.hash_gather_pairs_cuda
    pairs = sha256_cuda.hash_pairs_cuda
    before = (gather.launches, gather.plain_calls, pairs.launches,
              pairs.plain_calls, dict(merkle.stats), len(rec.sweeps))
    t0 = time.perf_counter()
    root = fn()
    torch.cuda.synchronize()
    row = dict(label=label, s=time.perf_counter() - t0,
               launches=gather.launches - before[0],
               pairs_launches=pairs.launches - before[2],
               device_pairs=merkle.stats["device_pairs"]
               - before[4]["device_pairs"],
               host_pairs=merkle.stats["host_pairs"] - before[4]["host_pairs"],
               sweeps=rec.sweeps[before[5]:])
    fused_s = sum(sw["s"] for sw in row["sweeps"])
    print(f"{label}: {row['s']:.6f} s, of which {fused_s:.6f} s in fused "
          f"sweeps; {row['launches']} sha256_gather launches, "
          f"{row['pairs_launches']} sha256_pairs launches, "
          f"{row['device_pairs']} pairs on the card, {row['host_pairs']} "
          f"pairs with hashlib", flush=True)
    for sw in row["sweeps"]:
        print(f"  fused sweep: {sw['rounds']} rounds, {sw['pairs']} pairs, "
              f"largest round {sw['largest']} pairs, {sw['literals']} "
              f"literals, {sw['uploaded']} uploaded, {sw['skipped']} "
              f"skipped (pool hits), {sw['s']:.6f} s")
    check(gather.plain_calls == before[1] and pairs.plain_calls == before[3],
          f"{label}: a wrapper took its plain version")
    oracle = host_oracle(state)
    check(root == oracle,
          f"{label}: incremental root {root.hex()} != oracle {oracle.hex()}")
    return root, row


@phase("incremental")
def incremental_phase():
    spec = get_spec("phase0", "mainnet")
    t0 = time.perf_counter()
    state = seeded_state(spec, N_VALIDATORS)
    full = state.copy()
    merkle.use_host_hashing()
    spec.process_slots(full, INC_END_SLOT)
    full_root = bytes(spec.hash_tree_root(full))
    merkle.use_device_hashing()
    del full
    print(f"copy advanced to slot {INC_END_SLOT} with full rebuilds and "
          f"host hashing: root {full_root.hex()}, "
          f"{time.perf_counter() - t0:.6f} s with the state's build")
    check(full_root.hex() == FULL_REBUILD_ROOT_101,
          f"full-rebuild root at slot {INC_END_SLOT} != "
          f"{FULL_REBUILD_ROOT_101}")

    def slot_step():
        spec.process_slots(state, state.slot + 1)
        return bytes(spec.hash_tree_root(state))

    sha256.reset_literal_pool()
    incremental.enable(guard_sample_rate=0.0)
    rec = FusedRecorder()
    sha256_cuda.hash_pairs_cuda.launches = 0
    sha256_cuda.hash_gather_pairs_cuda.launches = 0
    merkle.reset_stats()
    try:
        # (a) the cache build: process_slot's first state root sweeps
        # every leaf of the state in one fused sweep
        _, a = inc_step(f"(a) cache build, slot {START_SLOT} -> "
                        f"{START_SLOT + 1}", slot_step, rec, state)
        check(a["launches"] > 0, "(a) launched no sha256_gather")
        build = max(a["sweeps"], key=lambda sw: sw["pairs"])
        print(f"(a) cache build: {build['rounds']} rounds, largest round "
              f"{build['largest']} pairs, {build['pairs']} pairs, "
              f"{build['uploaded']} literals uploaded, {a['launches']} "
              f"launches, {build['s']:.6f} s in the fused sweep of "
              f"{a['s']:.6f} s for the step (the rest is the planner, "
              f"process_slot and the diff re-root)")

        # (b) per-slot re-roots: diff-sized, below the bulk threshold
        per_slot = []
        while state.slot < INC_END_SLOT:
            root, b = inc_step(f"(b) slot {int(state.slot)} -> "
                               f"{int(state.slot) + 1}", slot_step, rec, state)
            per_slot.append(b)
        check(root == full_root,
              f"incremental root at slot {INC_END_SLOT} {root.hex()} != "
              f"full-rebuild root {full_root.hex()}")
        print(f"(b) root at slot {INC_END_SLOT} == full-rebuild root; per "
              f"slot {sum(r['s'] for r in per_slot) / len(per_slot):.6f} s, "
              f"{sum(r['launches'] for r in per_slot)} sha256_gather launches "
              f"(every re-root is below the bulk threshold: hashlib)")

        # (c) an epoch-shaped diff: every balance, in one writeback
        rng = np.random.default_rng(SEED + 1)
        new_balances = np.asarray(state.balances, dtype=np.int64) \
            + rng.integers(-10**6, 10**6, N_VALIDATORS)

        def epoch_step():
            incremental.bulk_set_basic(state.balances,
                                       np.arange(N_VALIDATORS), new_balances)
            return bytes(spec.hash_tree_root(state))
        _, c = inc_step("(c) epoch-shaped diff, every balance", epoch_step,
                        rec, state)
        check(c["launches"] > 0, "(c) launched no sha256_gather")
        check(any(sw["literals"] > sha256._POOL_CAP
                  and sw["uploaded"] == sw["literals"] for sw in c["sweeps"]),
              "(c) did not take the pool-bypass branch")

        # (d) block-shaped diffs (bench.py bench_merkle_inc) with every
        # level on the card
        merkle.use_device_hashing(threshold=1)
        pick = random.Random(SEED)
        d = []
        for b in range(2):
            def block_step():
                state.slot = state.slot + 1
                for _ in range(COMMITTEE):
                    i = pick.randrange(N_VALIDATORS)
                    state.balances[i] = state.balances[i] + 1
                state.randao_mixes[b] = bytes([b + 1]) * 32
                return bytes(spec.hash_tree_root(state))
            _, row = inc_step(f"(d) block-shaped diff {b + 1}", block_step,
                              rec, state)
            check(row["launches"] > 0, f"(d) diff {b + 1} launched no "
                  f"sha256_gather")
            d.append(row)
        check(sum(sw["skipped"] for sw in d[1]["sweeps"]) > 0,
              "(d) the second diff found nothing in the literal pool")
    finally:
        merkle.use_device_hashing()
        rec.close()
        incremental.disable()
    launches = sha256_cuda.hash_gather_pairs_cuda.launches
    print(f"incremental path: {launches} sha256_gather launches, "
          f"{sha256_cuda.hash_pairs_cuda.launches} sha256_pairs launches")
    return launches, build["largest"]


@phase("gather kernel")
def gather_kernel_phase(n_sms, max_mhz, largest):
    """Two rounds of a sweep a size: round 0 gathers literals, round 1
    gathers literals and round-0 outputs (its right side always one)."""
    rng = np.random.default_rng(SEED + 2)
    max_err = 0
    timed = {}
    for n in sorted({*GATHER_SIZES, largest}):
        n_lits = max(2, n)
        words = rng.integers(0, 2**32, size=(n_lits, 8), dtype=np.uint32)
        words[0, :3] = (0x00000000, 0xFFFFFFFF, 0x80000000)
        words[1] = 0x80000000
        idx = [rng.integers(0, n_lits, n), rng.integers(0, n_lits, n),
               rng.integers(0, n_lits + n, n),
               rng.integers(n_lits, n_lits + n, n)]
        il0, ir0, il1, ir1 = (torch.from_numpy(i.astype(np.int32)).cuda()
                              for i in idx)
        buf = torch.zeros((n_lits + 2 * n, 8), dtype=torch.int32,
                          device="cuda")
        buf[:n_lits] = sha256.words_from_numpy(words, "cuda")
        plain = buf.clone()
        sha256_cuda.hash_gather_pairs_cuda(buf, il0, ir0, n_lits)
        sha256_cuda.hash_gather_pairs_cuda(buf, il1, ir1, n_lits + n)
        plain[n_lits:n_lits + n] = sha256.hash_gather_pairs(plain, il0, ir0)
        plain[n_lits + n:] = sha256.hash_gather_pairs(plain, il1, ir1)
        torch.cuda.synchronize()
        err = int((buf.long() - plain.long()).abs().max())
        max_err = max(max_err, err)
        check(err == 0, f"sha256_gather != plain version at {n} pairs a "
              f"round (max |diff| {err})")
        rows = sha256.words_to_bytes(buf)
        samples = sorted({0, n // 2, n - 1, *rng.integers(0, n, 8).tolist()})
        for r, (il, ir) in enumerate(((idx[0], idx[1]), (idx[2], idx[3]))):
            for k in samples:
                out = n_lits + r * n + k
                check(rows[32 * out:32 * out + 32] == hashlib.sha256(
                    rows[32 * il[k]:32 * il[k] + 32]
                    + rows[32 * ir[k]:32 * ir[k] + 32]).digest(),
                    f"sha256_gather round {r} row {k} of {n} != hashlib")
        print(f"{n} pairs a round: sha256_gather == plain bit for bit over "
              f"two rounds, {2 * len(samples)} rows == hashlib")
        if n in (1 << 17, largest):
            kernel_ms = graph_ms(lambda: sha256_cuda.hash_gather_pairs_cuda(
                buf, il0, ir0, n_lits), 50)
            eager_ms = cuda_ms(lambda: sha256_cuda.hash_gather_pairs_cuda(
                buf, il0, ir0, n_lits), 50)
            plain_ms = cuda_ms(lambda: sha256.hash_gather_pairs(
                buf, il0, ir0), 3)
            bound_ms, bound_by, op_ms, byte_ms = bound(
                n, GATHER_BYTES_PER_PAIR, n_sms, max_mhz)
            timed[n] = dict(ms=kernel_ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
            print(f"{n} pairs a round: sha256_gather {kernel_ms:.6f} ms "
                  f"({n / kernel_ms * 1e3:.0f} pairs/s; {eager_ms:.6f} ms "
                  f"a call launched eagerly), plain torch "
                  f"{plain_ms:.6f} ms; bound {op_ms:.6f} ms by "
                  f"{OPS_PER_PAIR * n} operations, {byte_ms:.6f} ms by "
                  f"{GATHER_BYTES_PER_PAIR * n} bytes; no PyTorch call "
                  f"computes SHA-256, so no library time")
    return max_err, timed[largest]


class EpochRecorder:
    """Host clocks around the parts of one fused epoch.  Each part is
    looked up by specs/epoch_fast.py when it is called, so wrapping the
    module attribute (or the spec instance's method) times it in place."""

    PARTS = (
        ("StateArrays", epoch_fast, "StateArrays"),
        ("phase0_attestation_masks", epoch_fast, "phase0_attestation_masks"),
        ("run_sweep: upload, kernels and download", epoch_sweep,
         "run_sweep"),
        ("guard: plain_sweep on the host", epoch_fast, "_guard"),
        ("writeback: _bulk_write of the balances", epoch_fast, "_bulk_write"),
        ("_apply_registry", epoch_fast, "_apply_registry"),
        ("effective-balance writes", epoch_fast,
         "_write_effective_balances"))

    def __init__(self, spec):
        self.calls = {}
        self.results = {}
        self._saved = []
        for label, owner, name in self.PARTS:
            self._wrap(label, owner, name, getattr(owner, name))
        for label, name in (("justification: weigh",
                             "weigh_justification_and_finalization"),
                            ("process_epoch", "process_epoch")):
            self._wrap(label, spec, name, getattr(spec, name), instance=True)

    def _wrap(self, label, owner, name, fn, instance=False):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.calls.setdefault(label, []).append(time.perf_counter() - t0)
            self.results[label] = out
            return out
        self._saved.append((owner, name, None if instance else fn))
        setattr(owner, name, run)

    def close(self):
        for owner, name, fn in self._saved:
            if fn is None:
                delattr(owner, name)
            else:
                setattr(owner, name, fn)

    def seconds(self, label):
        return sum(self.calls.get(label, ()))


@phase("epoch")
def epoch_phase():
    """The epoch path: process_slots 127 -> 128 on the card with
    incremental mode on and every sweep lane held against plain_sweep."""
    spec = get_spec("phase0", "mainnet")
    t0 = time.perf_counter()
    state = epoch_state(spec, N_VALIDATORS)
    print(f"epoch state of {N_VALIDATORS} validators at slot {EPOCH_SLOT} "
          f"({len(state.previous_epoch_attestations)} previous-epoch and "
          f"{len(state.current_epoch_attestations)} current-epoch pending "
          f"attestations) built in {time.perf_counter() - t0:.6f} s",
          flush=True)
    sweep = epoch_sweep_cuda.epoch_sweep_cuda
    gather = sha256_cuda.hash_gather_pairs_cuda
    sha256.reset_literal_pool()
    incremental.enable(guard_sample_rate=0.0)
    epoch_fast.set_guard(1.0)
    rec = EpochRecorder(spec)
    try:
        METRICS.reset()
        plain_calls = (sweep.plain_calls, gather.plain_calls)
        sweep.launches = 0
        gather.launches = 0
        t0 = time.perf_counter()
        spec.process_slots(state, EPOCH_SLOT + 1)
        torch.cuda.synchronize()
        slots_s = time.perf_counter() - t0
        launches = sweep.launches
        epoch_gather = gather.launches
        t0 = time.perf_counter()
        root = bytes(spec.hash_tree_root(state))
        torch.cuda.synchronize()
        reroot_s = time.perf_counter() - t0
        reroot_gather = gather.launches - epoch_gather
        check((sweep.plain_calls, gather.plain_calls) == plain_calls,
              "epoch: a wrapper took its plain version on the card path")
        t0 = time.perf_counter()
        oracle = host_oracle(state)
        oracle_s = time.perf_counter() - t0
    finally:
        rec.close()
        epoch_fast.set_guard(0.0)
        incremental.disable()
    snapshot = METRICS.snapshot()
    check(snapshot.get("epoch_sweep_dispatches") == 1,
          f"epoch: {snapshot.get('epoch_sweep_dispatches')} sweep "
          f"dispatches, expected 1")
    check(launches > 0, "epoch: the sweep launched no epoch_sweep kernel")
    check(snapshot.get("epoch_guard_samples") == 1
          and not snapshot.get("epoch_guard_mismatches"),
          "epoch: the guard did not hold every lane once")
    check(reroot_gather > 0,
          "epoch: the post-epoch re-root launched no sha256_gather")
    check(root == oracle,
          f"epoch: root at slot {EPOCH_SLOT + 1} {root.hex()} != host-hashed "
          f"oracle {oracle.hex()}")
    check(root.hex() == POST_EPOCH_ROOT_128,
          f"epoch: root at slot {EPOCH_SLOT + 1} {root.hex()} != the JAX "
          f"package's {POST_EPOCH_ROOT_128}")
    epoch_s = rec.seconds("process_epoch")
    masks = rec.calls.get("phase0_attestation_masks", [])
    print(f"epoch: process_slots {EPOCH_SLOT} -> {EPOCH_SLOT + 1} "
          f"{slots_s:.6f} s: process_slot's root (the cache build) "
          f"{slots_s - epoch_s:.6f} s, process_epoch {epoch_s:.6f} s")
    print(f"epoch: StateArrays {rec.seconds('StateArrays'):.6f} s")
    print(f"epoch: phase0_attestation_masks, previous epoch {masks[0]:.6f} s")
    weigh = rec.seconds("justification: weigh")
    print(f"epoch: justification {masks[1] + weigh:.6f} s (current-epoch "
          f"target mask {masks[1]:.6f} s, weigh {weigh:.6f} s)")
    for label, _owner, _name in EpochRecorder.PARTS[2:]:
        print(f"epoch: {label} {rec.seconds(label):.6f} s")
    print(f"epoch: re-root at slot {EPOCH_SLOT + 1} {reroot_s:.6f} s "
          f"({reroot_gather} sha256_gather launches); host-hashed oracle "
          f"{oracle_s:.6f} s")
    print(f"epoch: {rec.results['effective-balance writes']} effective "
          f"balances changed, {snapshot.get('epoch_writeback_elems')} "
          f"elements written back, {launches} epoch_sweep launches, "
          f"{epoch_gather} sha256_gather launches in process_slots")
    print(f"epoch: root at slot {EPOCH_SLOT + 1} {root.hex()} == host "
          f"oracle == JAX package")
    return launches


def sweep_columns(rng, n):
    """Seeded numpy columns of both sweep families at n lanes: FAR epochs
    in every epoch column, slashed lanes in and out of the slashings
    window, balances around the hysteresis thresholds, and source
    attesters whose best inclusion keys name EPOCH_PROPOSERS proposers.
    Returns (columns, scalars, electra's eff and max_eff)."""
    incr = 10**9
    far = np.uint64((1 << 64) - 1)
    cur, prev, finalized = 10, 9, 7
    slash_epoch = cur + 4096

    def epochs(far_share, lo, hi):
        e = rng.integers(lo, hi, n).astype(np.uint64)
        e[rng.random(n) < far_share] = far
        return e
    eff = (rng.integers(0, 33, n) * incr).astype(np.int64)
    eff[rng.random(n) < 0.05] = 16 * incr
    slashed = rng.random(n) < 0.08
    withdrawable = epochs(0.5, 0, 20)
    withdrawable[slashed & (rng.random(n) < 0.5)] = np.uint64(slash_epoch)
    balances = np.maximum(eff + rng.integers(-2 * incr, 2 * incr, n),
                          0).astype(np.int64)
    src = rng.random(n) < 0.8
    tgt = src & (rng.random(n) < 0.9)
    head = tgt & (rng.random(n) < 0.9)
    best_key = np.where(src, (rng.integers(1, 33, n) << 24)
                        | rng.integers(0, 1 << 20, n),
                        np.iinfo(np.int64).max).astype(np.int64)
    proposers = rng.integers(0, n, EPOCH_PROPOSERS)
    best_prop = np.where(src, rng.choice(proposers, n), 0).astype(np.int64)
    scores = rng.integers(0, 50, n).astype(np.int64)
    scores[rng.random(n) < 0.05] = 10**6
    cols = {
        "eff": eff, "slashed": slashed, "activation": epochs(0.1, 0, 12),
        "exit_epoch": epochs(0.7, 0, 14), "act_elig": epochs(0.2, 0, 12),
        "withdrawable": withdrawable, "balances": balances,
        "max_eff": np.full(n, 32 * incr, np.int64),
        "src": src, "tgt": tgt, "head": head, "best_key": best_key,
        "best_prop": best_prop,
        "part_prev": rng.integers(0, 8, n).astype(np.int64),
        "scores": scores}
    big = rng.random(n) < 0.3
    electra_max = np.where(big, 2048 * incr, 32 * incr).astype(np.int64)
    electra_eff = np.where(big, rng.integers(32, 2049, n) * incr,
                           eff).astype(np.int64)
    tb = max(incr, int(eff.sum()))
    scalars = {"cur": cur, "prev": prev, "finalized": finalized,
               "slash_epoch": slash_epoch, "tb": tb,
               "adj": min(3 * 10**15, tb), "sqrt_tb": math.isqrt(tb),
               "finality_delay": prev - finalized,
               "base_per_incr": incr * 64 // math.isqrt(tb), "bias": 4,
               "recovery": 16, "inact_denom": 4 * 50331648}
    return cols, scalars, (electra_eff, electra_max)


def sweep_case(base, case):
    """(columns on the card, scalars, statics) of one EPOCH_CASES case."""
    cols, scalars, (electra_eff, electra_max) = base
    family, leak, do_rewards, electra = EPOCH_CASES[case]
    names = (epoch_sweep.PHASE0_COLS if family == "phase0"
             else epoch_sweep.ALTAIR_COLS)
    picked = {k: cols[k] for k in names}
    if electra:
        picked.update(eff=electra_eff, max_eff=electra_max)
    statics = {"do_rewards": do_rewards, "leak": leak, "incr": 10**9,
               "max_eb": 32 * 10**9, "ejection": 16 * 10**9, "hyst_q": 4,
               "hyst_down": 1, "hyst_up": 5}
    if family == "phase0":
        statics.update(brf=64, brpe=4, prop_q=8, inact_q=1 << 26)
    else:
        statics.update(electra=electra, wd=64, target_flag=1,
                       flags=((0, 14, False), (1, 26, False), (2, 14, True)))
    on_card = {k: torch.from_numpy(
        v if k in epoch_sweep.BOOL_COLS else v.view(np.int64)).cuda()
        for k, v in picked.items()}
    return on_card, scalars, tuple(sorted(statics.items()))


def sweep_bytes(cols, lanes):
    """Bytes one sweep must move: each input lane read once, each output
    lane written once."""
    return (sum(t.numel() * t.element_size() for t in cols.values())
            + sum(t.numel() * t.element_size() for t in lanes))


@phase("epoch kernel")
def epoch_kernel_phase(n_sms, max_mhz):
    """epoch_sweep against plain_sweep on the card, bit for bit on every
    output lane, for every case at every size; then its times."""
    rng = np.random.default_rng(SEED + 4)
    sweep = epoch_sweep_cuda.epoch_sweep_cuda
    max_err = 0
    timed = None
    for n in EPOCH_KERNEL_SIZES:
        base = sweep_columns(rng, n)
        for case in EPOCH_CASES:
            cols, scalars, statics = sweep_case(base, case)
            got = sweep(cols, scalars, statics)
            want = epoch_sweep.plain_sweep(cols, scalars, statics)
            torch.cuda.synchronize()
            err = max(int((g.long() - w.long()).abs().max())
                      for g, w in zip(got, want))
            max_err = max(max_err, err)
            check(err == 0 and all(g.dtype == w.dtype
                                   for g, w in zip(got, want)),
                  f"epoch_sweep != plain_sweep at {n} lanes, {case} "
                  f"(max |diff| {err})")
        print(f"{n} lanes: epoch_sweep == plain_sweep bit for bit in "
              f"{len(EPOCH_CASES)} cases", flush=True)
        if n not in (EPOCH_TIMED, 1 << 20):
            continue
        cols, scalars, statics = sweep_case(base, "phase0")
        _buf, lanes = epoch_sweep.lane_buffers(False, n, "cuda")

        def run(c=cols):
            sweep(c, scalars, statics, out=lanes)
        kernel_ms = graph_ms(run, 50)
        eager_ms = cuda_ms(run, 50)
        plain_ms = cuda_ms(
            lambda: epoch_sweep.plain_sweep(cols, scalars, statics), 3)
        spread = dict(cols, best_prop=torch.arange(
            n, dtype=torch.int64, device="cuda"))
        spread_ms = graph_ms(lambda: run(spread), 50)
        a_cols, a_scalars, a_statics = sweep_case(base, "altair")
        _abuf, a_lanes = epoch_sweep.lane_buffers(True, n, "cuda")
        altair_ms = graph_ms(lambda: sweep(a_cols, a_scalars, a_statics,
                                           out=a_lanes), 50)
        n_bytes = sweep_bytes(cols, lanes)
        byte_ms = n_bytes / MEMORY_BYTES_PER_S * 1e3
        op_ms = EPOCH_OPS_PER_LANE * n / (
            n_sms * SCHEDULER_LANES_PER_SM_PER_CLOCK * max_mhz * 1e6) * 1e3
        a_byte_ms = sweep_bytes(a_cols, a_lanes) / MEMORY_BYTES_PER_S * 1e3
        print(f"{n} lanes, phase0 sweep (3 launches): epoch_sweep "
              f"{kernel_ms:.6f} ms from a CUDA graph, {eager_ms:.6f} ms "
              f"launched eagerly; with {EPOCH_PROPOSERS} proposers taking "
              f"every attester's atomic, against {spread_ms:.6f} ms with "
              f"a proposer a lane; plain torch {plain_ms:.6f} ms; bound "
              f"{byte_ms:.6f} ms by {n_bytes} bytes "
              f"({n_bytes / n:.0f} a lane), {op_ms:.6f} ms by "
              f"{EPOCH_OPS_PER_LANE * n} operations; altair sweep "
              f"{altair_ms:.6f} ms (bound {a_byte_ms:.6f} ms by bytes); "
              f"no PyTorch call computes the sweep, so no library time")
        if n == EPOCH_TIMED:
            timed = dict(ms=kernel_ms, plain_ms=plain_ms,
                         bound_ms=max(byte_ms, op_ms),
                         bound_by="bytes" if byte_ms >= op_ms
                         else "operations")
    return max_err, timed


def main():
    card, n_sms, max_mhz = device_phase()
    build_phase()
    max_err, times = kernel_phase(n_sms, max_mhz)
    launches = main_path_phase()
    gather_launches, largest = incremental_phase()
    gather_err, g = gather_kernel_phase(n_sms, max_mhz, largest)
    epoch_launches = epoch_phase()
    epoch_err, e = epoch_kernel_phase(n_sms, max_mhz)
    t = times[MAIN_PATH_PAIRS]
    print(json.dumps({"kernels": [{
        "name": "sha256_pairs", "route": "cuda",
        "source": "consensus_specs_tpu_torch/ops/csrc/sha256_pairs.cu",
        "replaces": "consensus_specs_tpu/ops/sha256_pallas.py:89",
        "launches": launches, "max_abs_err": max_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None}, {
        "name": "sha256_gather", "route": "cuda",
        "source": "consensus_specs_tpu_torch/ops/csrc/sha256_gather.cu",
        "replaces": "consensus_specs_tpu/ops/sha256.py:146",
        "launches": gather_launches, "max_abs_err": gather_err,
        "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": None}, {
        "name": "epoch_sweep", "route": "cuda",
        "source": "consensus_specs_tpu_torch/ops/csrc/epoch_sweep.cu",
        "replaces": "consensus_specs_tpu/ops/epoch_sweep.py:74",
        "launches": epoch_launches, "max_abs_err": epoch_err,
        "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
        "bound_by": e["bound_by"], "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
