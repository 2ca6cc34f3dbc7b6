#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Drives the port's two paths on the card, the per-slot BeaconState root
(slice 1) and incremental re-roots (slice 2), and holds every kernel of those
paths against its plain PyTorch version:

1. device: requires a CUDA card and prints its name and power limit;
2. build: builds both SHA-256 kernels, pair-hash and gather-hash, from the
   repository's sources;
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
   round, with rows checked against hashlib, and its times.

Each phase prints its seconds.  The second-to-last line is a JSON object with
one entry per kernel; the last line is {"ok": true, "device": {...}}.  Any
failure raises and exits non-zero.  There is no CPU path.
"""
import hashlib
import json
import random
import subprocess
import time

import numpy as np
import torch

import consensus_specs_tpu_torch as port
from consensus_specs_tpu_torch.ops import sha256, sha256_cuda
from consensus_specs_tpu_torch.specs import get_spec
from consensus_specs_tpu_torch.ssz import incremental, merkle

SEED = 2026
N_VALIDATORS = 1 << 18          # bench.py EPOCH_VALIDATORS
START_SLOT = 97                 # no epoch boundary up to slot 127
END_SLOT = 99                   # the main path: two process_slot calls
INC_END_SLOT = 101              # the incremental path: four
# the post-state root at slot 101 of the seeded state, advanced with full
# rebuilds (chip_smoke.py's four-slot main path before incremental re-roots)
FULL_REBUILD_ROOT_101 = (
    "9d5159b701792b2ec49b6180984c36ecd7bd55e18b4e3dbdd298da57be0366b6")
KERNEL_SIZES = (1, 255, 256, 257, 65537, 1 << 17, 1 << 20)
TIMED_SIZES = (1 << 17, 1 << 20)
MAIN_PATH_PAIRS = 1 << 17       # the largest level of the main path
GATHER_SIZES = (1, 255, 257, 65537, 1 << 17)  # and the cache build's largest
COMMITTEE = 128                 # bench.py COMMITTEE: balances a block credits

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
    sha256_cuda.build()
    print(f"sha256_pairs and sha256_gather built by {sha256_cuda.build_route} "
          f"into {sha256_cuda.BUILD_DIR}")


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


def seeded_state(spec, n):
    """Mainnet-preset phase0 state shaped like bench.py's epoch state:
    n active validators with synthetic keys, balances around 32 ETH, and
    seeded roots, mixes and slashings; at START_SLOT with an empty header
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
    state.slot = START_SLOT
    state.latest_block_header = spec.BeaconBlockHeader(
        slot=START_SLOT - 1, proposer_index=int(rng.integers(0, n)),
        parent_root=rng.bytes(32), body_root=rng.bytes(32))
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


def main():
    card, n_sms, max_mhz = device_phase()
    build_phase()
    max_err, times = kernel_phase(n_sms, max_mhz)
    launches = main_path_phase()
    gather_launches, largest = incremental_phase()
    gather_err, g = gather_kernel_phase(n_sms, max_mhz, largest)
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
        "bound_by": g["bound_by"], "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
