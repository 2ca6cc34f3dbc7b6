#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Drives the port's main path, the per-slot BeaconState root, on the card and
holds every kernel of that path against its plain PyTorch version:

1. device: requires a CUDA card and prints its name and power limit;
2. build: builds the SHA-256 pair-hash kernel from the repository's sources;
3. kernel: the kernel against the plain torch version on the card, bit for
   bit, at 1, 255, 256, 257, 65,537, 2**17 and 2**20 pairs, with rows checked
   against hashlib, and the times of kernel, plain version and host hashlib;
4. main path: a mainnet-preset phase0 BeaconState of 262,144 validators, made
   from a seed, advanced from slot 97 to 101 with `process_slots` on the card,
   and the same steps on a copy with host hashing; the post-states must be
   equal, and every slot must have launched the kernel.

Each phase prints its seconds.  The second-to-last line is a JSON object with
one entry per kernel; the last line is {"ok": true, "device": {...}}.  Any
failure raises and exits non-zero.  There is no CPU path.
"""
import hashlib
import json
import subprocess
import time

import numpy as np
import torch

import consensus_specs_tpu_torch as port
from consensus_specs_tpu_torch.ops import sha256, sha256_cuda
from consensus_specs_tpu_torch.specs import get_spec
from consensus_specs_tpu_torch.ssz import merkle

SEED = 2026
N_VALIDATORS = 1 << 18          # bench.py EPOCH_VALIDATORS
START_SLOT, END_SLOT = 97, 101  # four process_slot calls, no epoch boundary
KERNEL_SIZES = (1, 255, 256, 257, 65537, 1 << 17, 1 << 20)
TIMED_SIZES = (1 << 17, 1 << 20)
MAIN_PATH_PAIRS = 1 << 17       # the largest level of the main path

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
    print(f"sha256_pairs built by {sha256_cuda.build_route} "
          f"into {sha256_cuda.BUILD_DIR}")


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
            kernel_ms = cuda_ms(lambda: sha256_cuda.hash_pairs_cuda(x), 50)
            plain_ms = cuda_ms(lambda: sha256.hash_pairs(x), 3)
            t0 = time.perf_counter()
            for i in range(n):
                hashlib.sha256(data[64 * i:64 * (i + 1)]).digest()
            host_s = time.perf_counter() - t0
            ops = OPS_PER_PAIR * n
            op_ms = ops / (n_sms * SCHEDULER_LANES_PER_SM_PER_CLOCK
                           * max_mhz * 1e6) * 1e3
            byte_ms = BYTES_PER_PAIR * n / MEMORY_BYTES_PER_S * 1e3
            times[n] = dict(ms=kernel_ms, plain_ms=plain_ms,
                            bound_ms=max(op_ms, byte_ms),
                            bound_by="operations" if op_ms >= byte_ms
                            else "bytes",
                            host_ms=host_s * 1e3)
            print(f"{n} pairs: kernel {kernel_ms:.6f} ms "
                  f"({n / kernel_ms * 1e3:.0f} pairs/s), plain torch "
                  f"{plain_ms:.6f} ms, host hashlib {host_s * 1e3:.6f} ms "
                  f"({n / host_s:.0f} pairs/s); bound {op_ms:.6f} ms by "
                  f"{ops} operations, {byte_ms:.6f} ms by "
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
    merkle.reset_stats()
    card = run_slots(spec, state, "card", hashers)
    launches = sha256_cuda.hash_pairs_cuda.launches
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


def main():
    card, n_sms, max_mhz = device_phase()
    build_phase()
    max_err, times = kernel_phase(n_sms, max_mhz)
    launches = main_path_phase()
    t = times[MAIN_PATH_PAIRS]
    print(json.dumps({"kernels": [{
        "name": "sha256_pairs", "route": "cuda",
        "source": "consensus_specs_tpu_torch/ops/csrc/sha256_pairs.cu",
        "replaces": "consensus_specs_tpu/ops/sha256_pallas.py:89",
        "launches": launches, "max_abs_err": max_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
