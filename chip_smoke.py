#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

    python3 chip_smoke.py --only flush,block   (chosen phases, no result)

Drives the port's six paths on the card, the per-slot BeaconState root
(slice 1), incremental re-roots (slice 2), the phase0 epoch transition
(slice 3), phase0 block processing with every signature checked (slice 4),
the block's signature flush (slice 5) and the deneb KZG blob path (slice
7), and holds every kernel of those paths against its plain PyTorch
version:

1. device: requires a CUDA card and prints its name and power limit;
2. build: builds the kernels, SHA-256 pair-hash and gather-hash, the
   epoch sweep and the BLS12-381 pairing, G2 ladder, field, segment-sum, G1
   ladder, fold, cofactor, check and Pippenger kernels, from the
   repository's sources, and prints the BLS kernels' registers and stack
   (cuobjdump);
3. kernel: the pair-hash kernel against the plain torch version on the card,
   bit for bit, at 1, 255, 256, 257, 65,537, 2**17 and 2**20 pairs, with rows
   checked against hashlib, and the times of kernel (replayed from a CUDA
   graph, and launched eagerly), plain version and host hashlib, beside its
   bound by operations and bytes, and the time of its compiled SASS's
   busiest pipe (cuobjdump, counted by pipe);
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
   257, 65,537, 2**18 and 2**20 lanes, and its times beside its bound by
   bytes and operations;
9. bls kernels: every op of the field kernel on 2**16 seeded elements, the
   h_eff ladder on 1, 64 and 1,024 points (one plain call on the first 64 and
   64 seeded rows of the 1,024), and the Miller values, products and
   verdicts of a valid and an invalid check at k = 2, 129 and 1,024 pairs
   (the pairing kernel's two launches, four warps a pair or a job), each
   equal to the plain torch version on the card bit for bit; the cofactor
   kernel's affine words at 1, 64 and 1,024 points (a row of order 169
   and an infinity row from 64; the plain version on 128 seeded rows of
   the 1,024 with those two) equal to its plain psi version and to the
   ladder followed by the normalization, and the
   four-warp check's product before the final exponentiation and verdicts
   at k = 2, 129 and 1,024 and at 14 jobs of k = 2 equal to miller +
   product_final and to its plain version, bit for bit; the times of the
   main path's shapes (one check of two pairs, one cofactor clearing, and
   what they replace: one ladder, one affine normalization; the pairing's
   two launches beside the check) from a CUDA graph side by side, with
   the plain version's times and the operation bounds (the new kernels'
   from their plain versions' product counters);
10. bls: seeded Verify (valid, tampered, wrong key, infinity),
   FastAggregateVerify over a 128-key committee (valid, invalid) and
   AggregateVerify over 8 messages on the shim's device backend, each
   verdict equal to the native oracle's;
11. flush kernels: the segment-sum kernel (G1 at a block's 8 x 128, 64
   ragged segments up to 2,048 and the blob verify's 6 points of 8, G2 at
   one segment of 1,024 and the block fold's 14 of 16), the G1 ladder
   (1,024 and 16,384 lanes of 64 bits, the larger on a seeded sample of
   1,024 rows; 8 and 1,024 rows split by GLV, the split's edge scalars
   among them), the G2 ladder at the staged flush's 16 rows of 64 bits
   and the fold kernels (a set's three legs as three kernels
   on three streams, its cofactor by the psi kernel) with the Miller
   product after it (k = 16 from 14 sets and 256, valid and with one bad
   set) against their plain torch versions on the card, bit for bit; at
   k = 1,024 the verdict and the 1,025 legs against the host's integers;
   the times of the block's shapes, of the segment sums at their three
   paths' and of the blob verify's G1 ladder (8 split rows) from a CUDA
   graph; the pairing kernel's
   launches alone at the flush's shapes (launch 1 over the block's 17 legs
   and a 256-set flush's 257, launch 2 over one job of as many values
   without the final exponentiation and over the block's partial product
   with it), each bit for bit against the plain version, timed through
   its wrapper from a CUDA graph beside its plain time and bound;
12. flush: seeded flushes of 16 sets (set 8 bad) and 256 through
   `scheduler.verify_sets` as the one-launch fold, the staged fold and
   unfolded: the verdicts equal each other, the construction and the
   native oracle, with N + 1 Miller legs folded and 2N unfolded;
13. block: `block_case`, the same seeded state at slot 97 with real keys
   for its signers and a signed block at slot 98 (8 full-committee
   attestations, a proposer and an attester slashing: 14 signature
   checks), through `state_transition` with BLS on: the root must equal
   the host oracle and the JAX package's (POST_BLOCK_ROOT_98), every check
   must launch the cofactor kernel once and the four-warp pairing check
   once (and the ladder, field and two-launch pairing kernels never), and
   a copy with a tampered first attestation must be rejected there;
   then the same with `sigpipe.enable()`: the same root, 14 seam hits, one
   flush as one fold chain with no scalar ladder, and the tampered copy
   rejected at its attestation after bisection; prints each part's
   seconds;
14. msm kernel: the Pippenger kernel (five launches) against its plain
   torch version and the host oracle on the card, the result's affine
   words and compressed bytes, at 256 (edge rows), 300, 1,024
   and 4,096 points of the ceremony basis and 4,096 with every scalar
   equal; the kernel and the lanes engine timed at each size; at 4,096
   points each launch, the plain version and the bound;
15. kzg: the port's KZG engine on the ceremony setup with its device MSM
   (the default): bench.py's six blobs of 4,096 field elements, their
   commitments and blob proofs (12 Pippenger MSMs) equal to the JAX
   package's (KZG_COMMITMENTS, KZG_PROOFS, scripts/torch_kzg_reference.py),
   `verify_blob_kzg_proof_batch` True (three lincombs on the lanes engine,
   one host pairing) and False with two proofs swapped (the attribution
   counted), commit(constant c) == c G1; prints each part's host seconds.

Each phase prints its seconds.  The second-to-last line is a JSON object with
one entry per kernel; the last line is {"ok": true, "device": {...}}.  Any
failure raises and exits non-zero.  There is no CPU path.
"""
import functools
import hashlib
import json
import math
import os
import random
import re
import subprocess
import time
import traceback

import numpy as np
import torch

import consensus_specs_tpu_torch as port
from consensus_specs_tpu_torch.crypto import bls12_381
from consensus_specs_tpu_torch.crypto import curve as cv
from consensus_specs_tpu_torch.crypto.fields import R
from consensus_specs_tpu_torch.crypto import hash_to_curve as h2c
from consensus_specs_tpu_torch.crypto.fields import Q
from consensus_specs_tpu_torch.ops import (
    bls381_cuda, bls_cuda, cuda_build, curve_torch, epoch_sweep,
    epoch_sweep_cuda, fq, g1_sweep, pairing_torch, sha256, sha256_cuda)
from consensus_specs_tpu_torch.ops import fq_tower as ft
from consensus_specs_tpu_torch.parallel import shard_verify
from consensus_specs_tpu_torch import sigpipe
from consensus_specs_tpu_torch.sigpipe import METRICS
from consensus_specs_tpu_torch.sigpipe import cache as sig_cache
from consensus_specs_tpu_torch.sigpipe import fold as sig_fold
from consensus_specs_tpu_torch.sigpipe import scheduler as sig_scheduler
from consensus_specs_tpu_torch.sigpipe import sets as sig_sets
from consensus_specs_tpu_torch.sigpipe.sets import SignatureSet
from consensus_specs_tpu_torch.specs import epoch_fast, get_spec
from consensus_specs_tpu_torch.ssz import incremental, merkle, uint64
from consensus_specs_tpu_torch.ssz import uint_to_bytes
from consensus_specs_tpu_torch.utils import bls

SEED = 2026
N_VALIDATORS = 1 << 18          # bench.py EPOCH_VALIDATORS
START_SLOT = 97                 # no epoch boundary up to slot 127
END_SLOT = 99                   # the main path: two process_slot calls
INC_END_SLOT = 101              # the incremental path: four
EPOCH_SLOT = 127                # the epoch path: process_slots 127 -> 128
BLOCK_SLOT = START_SLOT + 1     # the block path: a signed block at slot 98
BLOCK_ATTESTATIONS = 8          # full committees of 128 at 262,144
BLOCK_SK_BASE = 0x5EED2026      # the first signer's secret key
# the post-state root at slot 101 of the seeded state, advanced with full
# rebuilds (chip_smoke.py's four-slot main path before incremental re-roots)
FULL_REBUILD_ROOT_101 = (
    "9d5159b701792b2ec49b6180984c36ecd7bd55e18b4e3dbdd298da57be0366b6")
# the JAX package's root at slot 128 of epoch_state(spec, N_VALIDATORS)
# after process_slots(state, 128), on the CPU
# (scripts/torch_epoch_reference_root.py)
POST_EPOCH_ROOT_128 = (
    "68891d02776f70579e92d08fa22c5e02bd4440b3f3761ca435846dc70d13f648")
# the JAX package's root at slot 98 of block_case(spec, N_VALIDATORS) after
# state_transition with its native BLS, on the CPU
# (scripts/torch_block_reference_root.py)
POST_BLOCK_ROOT_98 = (
    "4322c9332ce7ca714a9f939d0e1fd1b0290e7627c31bd49195dc786320b0a135")
KERNEL_SIZES = (1, 255, 256, 257, 65537, 1 << 17, 1 << 20)
TIMED_SIZES = (1 << 17, 1 << 20)
MAIN_PATH_PAIRS = 1 << 17       # the largest level of the main path
GATHER_SIZES = (1, 255, 257, 65537, 1 << 17)  # and the cache build's largest
COMMITTEE = 128                 # bench.py COMMITTEE: balances a block credits
EPOCH_KERNEL_SIZES = (1, 255, 257, 65537, 1 << 18, 1 << 20)
EPOCH_TIMED = 1 << 18           # the epoch path's sweep
EPOCH_PROPOSERS = 32            # a previous epoch's block proposers
EPOCH_SWEEP_LAUNCHES = 2        # a phase0 sweep with rewards: sums and scatter, lanes
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

# H100 SXM data sheet: HBM3 at 3.35 TB/s.  SM count and max clock are read
# from the card.  Each of an SM's four sub-partitions issues one 32-lane
# warp instruction a clock (128 lanes an SM; the data sheet's 67 TFLOP/s
# float32 is this rate with an FMA counted as two), and runs 16 lanes a
# clock of its integer pipe and 16 of the FMA pipe (64 lanes an SM each;
# the white paper's 64 INT32 and 128 FP32 lanes an SM).  An add, a shift
# or a move has a form on either pipe (IADD3 or IMAD.IADD, SHF or
# IMAD.SHL and IMAD.HI, MOV or IMAD.MOV); a logic op (LOP3) runs on the
# integer pipe only.
MEMORY_BYTES_PER_S = 3.35e12
ISSUE_LANES_PER_SM_PER_CLOCK = 128
INT_PIPE_LANES_PER_SM_PER_CLOCK = 64
FMA_PIPE_LANES_PER_SM_PER_CLOCK = 64
# 32-bit instructions one pair needs at the least, with the three-input
# forms Hopper has (LOP3 for any logic of three words, IADD3 for a sum of
# three, SHF for a rotate): a round is 14 (Sigma1 and Sigma0 3 SHF + 1 LOP3
# each, Ch 1, Maj 1, T1 2 IADD3, e 1, a 1), a schedule word 10 (sigma0 and
# sigma1 3 shifts + 1 LOP3 each, 2 IADD3), a block's feed-forward 8.  The
# message block has 64 rounds and 48 schedule words; the pad block's schedule
# is constant and needs no instruction.  Of these, the logic ops (4 a round,
# 2 a schedule word) have no form on the FMA pipe.
OPS_PER_PAIR = (64 * 14 + 48 * 10 + 8) + (64 * 14 + 8)
LOGIC_OPS_PER_PAIR = (64 * 4 + 48 * 2) + 64 * 4
# the pipes of the compiled SASS (sass_pipes), printed beside the bound:
# what this compilation puts on each pipe, not the least the function needs
INT_PIPE_OPS = frozenset((
    "IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "LEA", "ISETP",
    "SEL", "PRMT", "IMNMX", "IABS", "MOV", "PLOP3", "FSEL", "FSETP",
    "FMNMX", "BMSK", "SGXT", "P2R", "R2P", "VIADD", "VIMNMX"))
FMA_PIPE_OPS = frozenset(("IMAD", "IMUL", "FFMA", "FMUL", "FADD"))
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


def cuda_ms(fn, reps, warmup=2):
    """Mean milliseconds of fn() on the card, by CUDA events, after
    `warmup` calls."""
    for _ in range(warmup):
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
    from torch.utils import cpp_extension
    nvcc = os.path.join(cpp_extension.CUDA_HOME or "/usr/local/cuda", "bin",
                        "nvcc")
    release = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()
    print(f"sha256_pairs, sha256_gather, epoch_sweep, bls381_g2, "
          f"bls381_field, bls381_msm (G1 ladder), bls381_fold, "
          f"bls381_cofactor, bls381_check (with bls381_pairing's two "
          f"launches and the segment sums) and bls381_pippenger built by "
          f"{cuda_build.build_route} into {cuda_build.BUILD_DIR} with nvcc "
          f"{release[-1] if release else 'of unknown version'}")
    print_resource_usage()


def print_resource_usage():
    """Registers, stack and local memory of the BLS kernels as cuobjdump
    reads them from the built objects, and the resident threads an SM
    that their registers allow (65,536 registers an SM)."""
    from torch.utils import cpp_extension
    tool = os.path.join(cpp_extension.CUDA_HOME or "/usr/local/cuda", "bin",
                        "cuobjdump")
    for name in ("bls381_g2", "bls381_field", "bls381_msm", "bls381_fold",
                 "bls381_cofactor", "bls381_check", "bls381_pippenger"):
        objs = [f for f in os.listdir(cuda_build.BUILD_DIR)
                if f.startswith(name) and f.endswith(".o")]
        if not objs or not os.path.exists(tool):
            print(f"{name}: no object or no cuobjdump to read its resources")
            continue
        out = subprocess.run(
            [tool, "-res-usage", os.path.join(cuda_build.BUILD_DIR, objs[0])],
            capture_output=True, text=True, timeout=120).stdout
        kernel = ""
        for line in out.splitlines():
            if "Function" in line:
                # the kernel's name and field inside its mangled symbol
                start = line.rfind("bls381_")
                end = line.find("_kernel", start) + len("_kernel")
                field = re.match(r"I\d+(\w+?)E", line[end:])
                kernel = line[start:end] + (f"<{field.group(1)}>"
                                            if field else "")
                continue
            if "REG:" not in line:
                continue
            regs = int(line.split("REG:")[1].split()[0])
            threads = 65536 // max(regs, 1) // 32 * 32
            print(f"{name} {kernel}: {line.strip()} -> at most "
                  f"{min(threads, 2048)} resident threads an SM by registers")
    print_spills(("bls381_cofactor.cu", "bls381_check.cu", "bls381_fold.cu",
                  "bls381_pippenger.cu"))


def print_spills(sources):
    """ptxas -v of the redesigned kernels' sources, read from the build's
    log (cuda_build.BUILD_LOG): each one's entry (registers, stack, shared
    memory) and its spill stores and loads summed over every function (the
    kernel and its out-of-line device functions)."""
    if not os.path.exists(cuda_build.BUILD_LOG):
        print("no build log to read ptxas's report from")
        return
    with open(cuda_build.BUILD_LOG) as log:
        # a compile's command line (ninja's "[i/n] ..." or "[nvcc] -c ..."),
        # then its output
        parts = re.split(r"\n(?=\[)", "\n" + log.read())
    for src in sources:
        path = os.path.join(cuda_build.CSRC, src) + " "
        report = "".join(p for p in parts if path in p.split("\n", 1)[0])
        stores = loads = 0
        spilling = []
        for fn, props in re.findall(
                r"Function properties for (\S+)\n\s*(?:ptxas info\s*:\s*)?"
                r"(.*)", report):
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", props)
            if m and (int(m.group(1)) or int(m.group(2))):
                stores += int(m.group(1))
                loads += int(m.group(2))
                spilling.append(fn)
        entries = re.findall(r"Used \d+ registers.*", report)
        print(f"ptxas -v {src}: entry {'; '.join(entries) or 'not in the log'}"
              f"; spill stores {stores} bytes, spill loads {loads} bytes over"
              f" its functions"
              f"{' (' + ', '.join(spilling) + ')' if spilling else ''}")


def cuobjdump_sass(obj):
    """The SASS of a built object (cuobjdump -sass)."""
    from torch.utils import cpp_extension
    tool = os.path.join(cpp_extension.CUDA_HOME or "/usr/local/cuda", "bin",
                        "cuobjdump")
    check(os.path.exists(tool), "no cuobjdump to read the SASS with")
    return subprocess.run([tool, "-sass", obj], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def sass_functions(sass):
    """Each function's instructions in `sass`, by pipe: {name: {"int",
    "fma", "issue" (every instruction but NOP), "other" (a Counter of
    the opcodes on neither pipe)}}."""
    from collections import Counter
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = {"int": 0, "fma": 0, "issue": 0,
                            "other": Counter()}
            continue
        if not (name and line.strip().startswith("/*") and ";" in line):
            continue
        op = line.split("*/", 1)[1].split()
        op = (op[1] if op and op[0].startswith("@") else op[0]).split(".")[0]
        if op == "NOP":
            continue
        c = counts[name]
        c["issue"] += 1
        if op in INT_PIPE_OPS:
            c["int"] += 1
        elif op in FMA_PIPE_OPS:
            c["fma"] += 1
        else:
            c["other"][op] += 1
    return counts


def sass_pipes(source, kernels):
    """The instructions of the kernels whose names hold one of `kernels`,
    summed, by pipe (sass_functions), from the SASS of `source`'s object
    in the build.  A straight-line kernel (the SHA-256 pair a thread)
    runs each once a thread; a kernel that branches is over-counted by
    the branches a thread does not take."""
    from collections import Counter
    objs = [f for f in os.listdir(cuda_build.BUILD_DIR)
            if f.startswith(source + ".") and f.endswith(".o")]
    check(objs, f"no object of {source} in {cuda_build.BUILD_DIR}")
    total = {"int": 0, "fma": 0, "issue": 0, "other": Counter()}
    for name, c in sass_functions(cuobjdump_sass(
            os.path.join(cuda_build.BUILD_DIR, objs[0]))).items():
        if any(k in name for k in kernels):
            for key in total:
                total[key] += c[key]
    check(total["issue"], f"no SASS of {kernels} in {objs[0]}")
    return total


def pipe_ms(pipes, items, n_sms, max_mhz):
    """(ms, pipe) the busiest pipe takes for `items` threads that each run
    the instructions `pipes` counts."""
    lanes = {"issue": pipes["issue"] / ISSUE_LANES_PER_SM_PER_CLOCK,
             "int": pipes["int"] / INT_PIPE_LANES_PER_SM_PER_CLOCK,
             "fma": pipes["fma"] / FMA_PIPE_LANES_PER_SM_PER_CLOCK}
    busiest = max(lanes, key=lanes.get)
    return (lanes[busiest] * items / (n_sms * max_mhz * 1e6) * 1e3,
            busiest)


def pipes_text(pipes):
    other = ", ".join(f"{op} {c}" for op, c in
                      pipes["other"].most_common(8))
    return (f"{pipes['issue']} instructions: {pipes['int']} on the integer "
            f"pipe, {pipes['fma']} on the FMA pipe, others {other}")


def bound(n_pairs, bytes_per_pair, n_sms, max_mhz):
    """(bound_ms, bound_by, op_ms, byte_ms) of n_pairs 2-to-1 hashes: the
    least instructions a pair needs at the issue rate, or their logic ops
    at the integer pipe's, whichever is slower, against the bytes."""
    clocks = max(OPS_PER_PAIR / ISSUE_LANES_PER_SM_PER_CLOCK,
                 LOGIC_OPS_PER_PAIR / INT_PIPE_LANES_PER_SM_PER_CLOCK)
    op_ms = clocks * n_pairs / (n_sms * max_mhz * 1e6) * 1e3
    byte_ms = bytes_per_pair * n_pairs / MEMORY_BYTES_PER_S * 1e3
    return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms
            else "bytes", op_ms, byte_ms)


def compiled_text(pipes, n_pairs, n_sms, max_mhz):
    """The compiled SASS's busiest pipe's time for n_pairs, as printed."""
    ms, pipe = pipe_ms(pipes, n_pairs, n_sms, max_mhz)
    return (f"as compiled, its SASS's busiest pipe ({pipe}) takes "
            f"{ms:.6f} ms")


@phase("kernel")
def kernel_phase(n_sms, max_mhz):
    rng = np.random.default_rng(SEED)
    max_err = 0
    times = {}
    pipes = sass_pipes("sha256_pairs", ("sha256_pairs_kernel",))
    print(f"sha256_pairs SASS, a pair: {pipes_text(pipes)}")
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
                  f"{BYTES_PER_PAIR * n} bytes; "
                  f"{compiled_text(pipes, n, n_sms, max_mhz)}; no PyTorch "
                  f"call computes SHA-256, so no library time")
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


def consecutive_keys(count, base):
    """`count` secret keys base, base + 1, ... and their compressed
    pubkeys, each pubkey the previous one plus G (one point add a key, not
    a scalar multiplication)."""
    g = cv.g1_generator()
    point = g * base
    pubkeys = []
    for _ in range(count):
        pubkeys.append(cv.g1_to_bytes(point))
        point = point + g
    return [base + i for i in range(count)], pubkeys


def _signing_root(spec, state, obj, domain_type, epoch):
    return spec.compute_signing_root(
        obj, spec.get_domain(state, domain_type, epoch))


def block_case(spec, n, n_attestations=BLOCK_ATTESTATIONS):
    """The block path's input: `seeded_state(spec, n)` at slot 97 with real
    keys for its signers, and a signed block at slot 98 carrying
    `n_attestations` full-committee attestations (of slot 97, and of the
    slots below it where slot 97 has fewer committees), one proposer
    slashing and one attester slashing (a double vote of [a, b] and
    [b, c]: b is slashed).  That is n_attestations + 6 signature checks:
    the block, its randao reveal, two slashed headers, two indexed
    attestations and the attestations.

    The signers (the proposer, the committees, the slashed proposer and
    a, b, c) get consecutive secret keys; an aggregate signature is
    Sign(sum of the signers' keys mod r, root).  The block's state root
    comes from one state_transition of a copy with BLS off.  Returns
    (pre-state, signed block, facts), facts holding the committees
    (slot, index, size), the signers' count and `resign`, which signs a
    block message with the proposer's key."""
    state = seeded_state(spec, n)
    rng = np.random.default_rng(SEED + 5)
    spe = int(spec.SLOTS_PER_EPOCH)
    epoch = START_SLOT // spe
    active = list(range(n))               # every seeded validator is active
    cps = max(1, min(int(spec.MAX_COMMITTEES_PER_SLOT),
                     n // spe // int(spec.TARGET_COMMITTEE_SIZE)))
    picks = [(slot, index) for slot in range(START_SLOT, START_SLOT - spe, -1)
             for index in range(cps)][:n_attestations]
    committees = {}
    for slot, index in picks:
        seed = spec.get_seed(state, slot // spe, spec.DOMAIN_BEACON_ATTESTER)
        committees[(slot, index)] = [int(i) for i in spec.compute_committee(
            active, seed, (slot % spe) * cps + index, cps * spe)]
    proposer_seed = spec.hash(
        bytes(spec.get_seed(state, epoch, spec.DOMAIN_BEACON_PROPOSER))
        + uint_to_bytes(uint64(BLOCK_SLOT)))
    proposer = int(spec.compute_proposer_index(state, active, proposer_seed))
    busy = {proposer, *(i for c in committees.values() for i in c)}
    free = [int(i) for i in rng.permutation(n) if int(i) not in busy]
    slashed_proposer, a, b, c = free[:4]
    signers = list(dict.fromkeys(
        [proposer, slashed_proposer, a, b, c]
        + [i for com in committees.values() for i in com]))
    sks, pks = consecutive_keys(len(signers), BLOCK_SK_BASE)
    sk_of = dict(zip(signers, sks))
    for i, pk in zip(signers, pks):
        state.validators[i].pubkey = pk

    def sign(indices, root):
        return bls12_381.Sign(sum(sk_of[i] for i in indices) % R, root)

    attestations = []
    for (slot, index), committee in committees.items():
        ep = slot // spe
        data = spec.AttestationData(
            slot=slot, index=index,
            beacon_block_root=state.block_roots[
                slot % spec.SLOTS_PER_HISTORICAL_ROOT],
            source=(state.current_justified_checkpoint if ep == epoch
                    else state.previous_justified_checkpoint),
            target=spec.Checkpoint(epoch=ep,
                                   root=spec.get_block_root(state, ep)))
        attestations.append(spec.Attestation(
            aggregation_bits=[True] * len(committee), data=data,
            signature=sign(committee, _signing_root(
                spec, state, data, spec.DOMAIN_BEACON_ATTESTER, ep))))

    headers = []
    for state_root in (b"\x44" * 32, b"\x99" * 32):
        header = spec.BeaconBlockHeader(
            slot=START_SLOT, proposer_index=slashed_proposer,
            parent_root=b"\x33" * 32, state_root=state_root,
            body_root=b"\x55" * 32)
        headers.append(spec.SignedBeaconBlockHeader(
            message=header, signature=sign([slashed_proposer], _signing_root(
                spec, state, header, spec.DOMAIN_BEACON_PROPOSER, epoch))))
    indexed = []
    for votes, head in (((a, b), b"\x01"), ((b, c), b"\x03")):
        data = spec.AttestationData(
            slot=START_SLOT - 1, index=0, beacon_block_root=head * 32,
            source=state.current_justified_checkpoint,
            target=spec.Checkpoint(epoch=epoch, root=b"\x02" * 32))
        indexed.append(spec.IndexedAttestation(
            attesting_indices=sorted(votes), data=data,
            signature=sign(votes, _signing_root(
                spec, state, data, spec.DOMAIN_BEACON_ATTESTER, epoch))))

    header = state.latest_block_header.copy()
    header.state_root = spec.hash_tree_root(state)
    body = spec.BeaconBlockBody(
        randao_reveal=sign([proposer], _signing_root(
            spec, state, uint64(epoch), spec.DOMAIN_RANDAO, epoch)),
        eth1_data=state.eth1_data,
        proposer_slashings=[spec.ProposerSlashing(
            signed_header_1=headers[0], signed_header_2=headers[1])],
        attester_slashings=[spec.AttesterSlashing(
            attestation_1=indexed[0], attestation_2=indexed[1])],
        attestations=attestations)
    block = spec.BeaconBlock(slot=BLOCK_SLOT, proposer_index=proposer,
                             parent_root=spec.hash_tree_root(header),
                             body=body)
    post = state.copy()
    saved = bls.bls_active
    bls.bls_active = False
    try:
        spec.state_transition(post, spec.SignedBeaconBlock(message=block),
                              validate_result=False)
    finally:
        bls.bls_active = saved
    block.state_root = spec.hash_tree_root(post)

    def resign(message):
        return spec.SignedBeaconBlock(message=message, signature=sign(
            [proposer], _signing_root(spec, state, message,
                                      spec.DOMAIN_BEACON_PROPOSER, epoch)))
    facts = dict(committees=[(s, i, len(c)) for (s, i), c in
                             committees.items()],
                 signers=len(signers), proposer=proposer, resign=resign)
    return state, resign(block), facts


def tampered_block(spec, signed_block, facts):
    """The block with its first attestation's signature replaced by the
    second's (a valid point, the wrong signature), signed again by the
    proposer: state_transition must reject it at that attestation."""
    message = signed_block.message.copy()
    message.body.attestations[0].signature = \
        message.body.attestations[1].signature
    return facts["resign"](message)


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
    pipes = sass_pipes("sha256_gather", ("sha256_gather_kernel",))
    print(f"sha256_gather SASS, a pair: {pipes_text(pipes)}")
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
                  f"{GATHER_BYTES_PER_PAIR * n} bytes; "
                  f"{compiled_text(pipes, n, n_sms, max_mhz)}; no PyTorch "
                  f"call computes SHA-256, so no library time")
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
    check(launches == EPOCH_SWEEP_LAUNCHES,
          f"epoch: the sweep launched {launches} epoch_sweep kernels, "
          f"expected {EPOCH_SWEEP_LAUNCHES}")
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
        launches = sweep.launches
        run()
        launches = sweep.launches - launches
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
            n_sms * ISSUE_LANES_PER_SM_PER_CLOCK * max_mhz * 1e6) * 1e3
        a_byte_ms = sweep_bytes(a_cols, a_lanes) / MEMORY_BYTES_PER_S * 1e3
        print(f"{n} lanes, phase0 sweep ({launches} launches): epoch_sweep "
              f"{kernel_ms:.6f} ms from a CUDA graph, {eager_ms:.6f} ms "
              f"launched eagerly; with {EPOCH_PROPOSERS} proposers taking "
              f"every attester's reward, against {spread_ms:.6f} ms with "
              f"a proposer a lane; plain torch {plain_ms:.6f} ms; bound "
              f"{byte_ms:.6f} ms by {n_bytes} bytes "
              f"({n_bytes / n:.0f} a lane), {op_ms:.6f} ms by "
              f"{EPOCH_OPS_PER_LANE * n} operations; altair sweep "
              f"{altair_ms:.6f} ms (bound {a_byte_ms:.6f} ms by bytes); no "
              f"PyTorch call computes the sweep, so no library time")
        if n == EPOCH_TIMED:
            timed = dict(ms=kernel_ms, plain_ms=plain_ms,
                         bound_ms=max(byte_ms, op_ms),
                         bound_by="bytes" if byte_ms >= op_ms
                         else "operations")
    return max_err, timed


# ---------------------------------------------------------------------------
# the BLS kernels, the BLS shim and the block path
# ---------------------------------------------------------------------------

# Fq products of the kernels' formulas (csrc/bls381.cuh), counted from
# their code: the operation bound of a BLS launch is its products' CIOS
# multiplies (MULS_PER_FQ_PRODUCT, each 32 x 32 -> 64-bit partial product
# counted as two 32-bit multiplies, lo and hi, plus the 12 of m) at
# INT_MULS_PER_SM_PER_CLOCK, the 32-bit integer multiply rate of compute
# capability 9.0 (CUDA programming guide, arithmetic instruction table).
MULS_PER_FQ_PRODUCT = 2 * 2 * 12 * 12 + 12
INT_MULS_PER_SM_PER_CLOCK = 64
_X_ONES = bin(pairing_torch.BLS_X_ABS)[3:].count("1")
FQ_INV = 380 + bin(Q - 2)[3:].count("1")
# the redesigned kernels' Fq inverse (csrc/bls381_reg.cuh rq_inv): a binary
# GCD on the ALU pipe, whose shift and subtract steps are not counted, then
# one product by R^3
GCD_FQ_INV = 1
FQ2_INV = 4 + FQ_INV
FQ6_INV = 33 + FQ2_INV
FQ12_INV = 72 + FQ6_INV
EXP_BY_X = 63 * 18 + _X_ONES * 54
# a line (c0 + c1 v + c4 v w) is sparse: multiplying by it needs 13 Fq2
# products, where the kernels and the plain version multiply it as a dense
# Fq12 (54); the bounds count what is needed, as they count f^2 as a square
LINE_PRODUCTS = 13 * 3
MILLER_PRODUCTS = 63 * (34 + 36 + LINE_PRODUCTS) \
    + _X_ONES * (43 + LINE_PRODUCTS)
FINAL_EXP_PRODUCTS = (FQ12_INV + 2 * 54 + 2 * 18) + 2 * 18 + 5 * EXP_BY_X \
    + 10 * 54 + 6 * 18
# products of one element of each field op (points: the generic add)
FIELD_PRODUCTS = {
    "fq_mul": 1, "fq_add": 0, "fq_sub": 0, "fq_neg": 0, "fq_inv": FQ_INV,
    "fq2_mul": 3, "fq2_square": 2, "fq2_inv": FQ2_INV, "fq12_mul": 54,
    "fq12_square": 36, "fq12_cyclotomic_square": 18, "fq12_frobenius1": 18,
    "fq12_frobenius2": 36, "fq12_frobenius3": 54, "fq12_conj": 0,
    "fq12_inv": FQ12_INV, "g1_add": 16, "g1_double": 7, "g2_add": 43,
    "g2_double": 16}
G2_DOUBLE_PRODUCTS, G2_ADD_PRODUCTS = 16, 43
FIELD_ELEMENTS = 1 << 16
# plain-version elements a call on the card, by element words (bounds the
# plain products' float64 intermediates to a few GiB)
FIELD_CHUNK = {12: 1 << 16, 24: 1 << 16, 36: 1 << 15, 72: 1 << 13,
               144: 1 << 13}
LADDER_SIZES = (1, 64, 1024)
MILLER_SIZES = (2, 129, 1024)
COFACTOR_SIZES = (1, 64, 1024)  # Kernel A's holds (an infinity row from 64)
# rows of a ladder or cofactor run above this size that the plain version
# holds: a seeded sample with the last two (the cofactor's edge rows)
HOLD_SAMPLE = 128
CHECK_JOBS = 14                 # Kernel B at a block's 14 checks of k = 2
# Kernel A's Fq products a point (csrc/bls381_reg.cuh cofactor_elem),
# counted from the method, which gives its bound: two multiplications by x
# (63 doublings, 5 adds each), three psi (2 Fq2 products each), a doubling,
# five adds, the Fq2 inverse (4 products and the binary GCD's) and the 11
# affine products.  The kernel also computes, in each of its 15 adds, the
# doubling its select may discard.
COFACTOR_METHOD_PRODUCTS = \
    2 * (63 * G2_DOUBLE_PRODUCTS + 5 * G2_ADD_PRODUCTS) + 3 * 6 \
    + G2_DOUBLE_PRODUCTS + 5 * G2_ADD_PRODUCTS + 4 + GCD_FQ_INV + 11
COFACTOR_PRODUCTS = COFACTOR_METHOD_PRODUCTS + 15 * G2_DOUBLE_PRODUCTS
FAV_COMMITTEE = 128
CARD = "cuda"                   # where the BLS phases put their tensors
AV_MESSAGES = 8


def timed_once(fn):
    """(ms, fn()) of one run of fn on the card, by CUDA events (no
    warm-up)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def plain_products(fn):
    """(ms, products) of one plain torch run of fn on the card (no
    warm-up): its Fq products by `fq.mul.count`, each Fq inverse counted
    as the redesigned kernels' GCD_FQ_INV where the plain version takes
    FQ_INV."""
    fermat, inverses = ft.fq_inv, []

    def counted_inv(a):
        inverses.append(a.numel() // fq.LIMBS)
        return fermat(a)
    ft.fq_inv = counted_inv
    fq.mul.count = 0
    try:
        ms = cuda_ms(fn, 1, warmup=0)
    finally:
        ft.fq_inv = fermat
    return ms, fq.mul.count - sum(inverses) * (FQ_INV - GCD_FQ_INV)


def op_bound(products, n_bytes, n_sms, max_mhz):
    """(bound_ms, bound_by) of `products` Fq products moving n_bytes."""
    op_ms = products * MULS_PER_FQ_PRODUCT / (
        n_sms * INT_MULS_PER_SM_PER_CLOCK * max_mhz * 1e6) * 1e3
    byte_ms = n_bytes / MEMORY_BYTES_PER_S * 1e3
    return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms
            else "bytes")


def _canonical_limbs(gen, shape):
    """Seeded canonical Fq limbs (< q) on the card: 31 random 12-bit limbs
    and a top limb below q's; the first rows are 0, 1 (Montgomery) and
    q - 1."""
    lo = torch.randint(0, 1 << 12, shape + (31,), generator=gen,
                       dtype=torch.int64)
    hi = torch.randint(0, Q >> 372, shape + (1,), generator=gen,
                       dtype=torch.int64)
    out = torch.cat([lo, hi], dim=-1)
    flat = out.reshape(-1, 32)
    flat[0] = 0
    flat[1] = torch.from_numpy(fq.ONE_MONT_LIMBS)
    flat[2] = torch.from_numpy(fq.Q_LIMBS) - torch.tensor([1] + [0] * 31)
    return out.to(CARD)


def _field_inputs(op, gen, n):
    suffix, arity, _plain = bls381_cuda.FIELD_OPS[op]
    a = _canonical_limbs(gen, (n,) + suffix[:-1])
    b = _canonical_limbs(gen, (n,) + suffix[:-1]) if arity == 2 else None
    if op.startswith("g"):
        z = -2 if op.startswith("g1") else -3      # the Z coordinate
        a.select(z, 2)[3] = 0                      # infinity on the left
        if b is not None:
            b.select(z, 2)[4] = 0                  # infinity on the right
            b[5] = a[5]                            # equal: doubles
            b[6] = a[6]
            y = b[6].select(z, 1)                  # negated: infinity
            y.copy_(bls381_cuda.FIELD_OPS["fq_neg"][2](y))
    return a, b


def _plain_chunked(plain, a, b):
    chunk = FIELD_CHUNK[a[0].numel() // 32 * 12]
    outs = []
    for i in range(0, a.shape[0], chunk):
        sl = slice(i, i + chunk)
        outs.append(plain(a[sl]) if b is None else plain(a[sl], b[sl]))
    return torch.cat(outs)


def _pairing_jobs(k, valid):
    """One job of k pairs, as limb tensors on the card: P_i consecutive
    multiples of G1, Q_i among four multiples of G2, and the last pair
    (-(sum of s_i t_i) G1, G2) so that the product is one (or, invalid,
    off by one)."""
    g1, g2 = cv.g1_generator(), cv.g2_generator()
    ts = [3, 5, 7, 11]
    qs = [g2 * t for t in ts]
    s0 = 1000003
    p = g1 * s0
    pairs, total = [], 0
    for i in range(k - 1):
        pairs.append((p, qs[i % 4]))
        total += (s0 + i) * ts[i % 4]
        p = p + g1
    pairs.append((g1 * ((-total + (0 if valid else 1)) % R), g2))
    xs1, ys1, xs2, ys2 = [], [], [], []
    for p, q in pairs:
        (x1, y1), (x2, y2) = p.affine(), q.affine()
        xs1.append(x1.v)
        ys1.append(y1.v)
        xs2.append(x2)
        ys2.append(y2)
    return (fq.pack_mont(xs1, CARD), fq.pack_mont(ys1, CARD),
            ft.fq2_pack_mont(xs2, CARD), ft.fq2_pack_mont(ys2, CARD))


def _ladder_points(n):
    """n G2 points in Jacobian form on the card: a hashed point and its
    successors by G2 (not in the subgroup: the ladder does not care)."""
    u0, u1 = h2c.hash_to_field_fq2(b"chip smoke ladder", 2, h2c.DST_G2)
    p = h2c.iso_map(*h2c.sswu_map(u0)) + h2c.iso_map(*h2c.sswu_map(u1))
    g2 = cv.g2_generator()
    pts = []
    for _ in range(n):
        pts.append(p)
        p = p + g2
    return curve_torch.g2_pack(pts, CARD)


def _old_affine_g2(pt):
    """The check-by-check path's affine normalization before Kernel A: four
    field-kernel launches, x = X / Z^2, y = Y / Z^3 (zeros where Z = 0)."""
    X, Y, Z = pt
    zinv = bls381_cuda.field_op("fq2_inv", Z)
    zinv2 = bls381_cuda.field_op("fq2_square", zinv)
    zinv3 = bls381_cuda.field_op("fq2_mul", zinv2, zinv)
    xy = bls381_cuda.field_op("fq2_mul", torch.stack([X, Y]),
                              torch.stack([zinv2, zinv3]))
    return xy[0], xy[1]


# the cofactor of G2 in E'(Fq2): 13^2 23^2 2713 11953 262069 times a large
# prime
G2_COFACTOR = int(
    "5d543a95414e7f1091d50792876a202cd91de4547085abaa68a205b2e5a7ddfa628f1c"
    "b4d9e82ef21537e293a6691ae1616ec6e786f0c70cf1c38e31c7238e5", 16)


def _torsion_point():
    """A point of order 169 on E'(Fq2): the ladders of the psi method meet
    opposite and infinite inputs in their adds, and h_eff P is infinity."""
    u0, u1 = h2c.hash_to_field_fq2(b"\x02" * 3, 2, h2c.DST_G2)
    p = h2c.iso_map(*h2c.sswu_map(u0)) + h2c.iso_map(*h2c.sswu_map(u1))
    return p * (G2_COFACTOR * R // 169)


def _cofactor_points(n):
    """Kernel A's inputs: `_ladder_points(n)`, from 64 rows on with a point
    of order 169 and the point at infinity as the last two."""
    pt = _ladder_points(n)
    if n >= 64:
        edge = curve_torch.g2_pack([_torsion_point(), cv.g2_infinity()],
                                   CARD)
        for c, e in zip(pt, edge):
            c[-2:] = e
    return pt


def _hold_rows(n, head=0):
    """Rows of an n-row ladder or cofactor run that the plain version
    holds: every row up to HOLD_SAMPLE, else HOLD_SAMPLE rows: the first
    `head`, a seeded sample of the rest and the last two."""
    size = HOLD_SAMPLE
    if n <= size:
        return torch.arange(n, device=CARD)
    rng = np.random.default_rng([SEED, 16, n, size])
    rest = head + rng.choice(n - 2 - head, size - 2 - head, replace=False)
    return torch.from_numpy(np.concatenate(
        [np.arange(head), np.sort(rest), [n - 2, n - 1]])).to(CARD)


def _max_err(got, want):
    if isinstance(got, (tuple, list)):
        return max(_max_err(g, w) for g, w in zip(got, want))
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


@phase("bls kernels")
def bls_kernels_phase(n_sms, max_mhz):
    """The five scalar BLS kernels against their plain torch versions on
    the card, bit for bit: every field op on 2^16 seeded elements, the h_eff
    ladder on 1, 64 and 1,024 points (HOLD_SAMPLE rows held), Miller
    products and verdicts
    of a valid and an invalid check at k = 2, 129 and 1,024 pairs; the
    cofactor kernel (psi) on 1, 64 and 1,024 points against its plain
    version and the ladder plus normalization; the four-warp check at the
    same k and at 14 jobs of k = 2 against miller + product_final and its
    plain version; then the times of the main path's shapes from a CUDA
    graph, old and new side by side, with the plain version's times and
    the operation bounds."""
    gen = torch.Generator().manual_seed(SEED + 6)
    max_err = {"bls381_field": 0, "bls381_g2": 0, "bls381_pairing": 0,
               "bls381_cofactor": 0, "bls381_check": 0}
    for op, (suffix, arity, plain) in bls381_cuda.FIELD_OPS.items():
        a, b = _field_inputs(op, gen, FIELD_ELEMENTS)
        got = bls381_cuda.field_op(op, a, b)
        want = _plain_chunked(plain, a, b)
        torch.cuda.synchronize()
        err = _max_err(got, want)
        max_err["bls381_field"] = max(max_err["bls381_field"], err)
        check(err == 0, f"bls381_field {op} != plain at {FIELD_ELEMENTS} "
              f"elements (max |diff| {err})")
        kernel_ms = graph_ms(lambda: bls381_cuda.field_op(op, a, b), 10)
        # the kernel alone, on words already repacked (the wrapper's
        # limb <-> word repacking is plain torch around it)
        words = [fq.to_words(t).contiguous() for t in (a, b)
                 if t is not None]
        out = torch.empty_like(words[0])
        launch = cuda_build.build().field
        alone_ms = graph_ms(lambda: launch(
            bls381_cuda._OP_CODE[op], words[0],
            words[1] if b is not None else None, out, FIELD_ELEMENTS), 10)
        n_bytes = (arity + 1) * a.numel() // 32 * 12 * 4
        bound_ms, bound_by = op_bound(FIELD_PRODUCTS[op] * FIELD_ELEMENTS,
                                      n_bytes, n_sms, max_mhz)
        print(f"bls381_field {op}: == plain bit for bit at "
              f"{FIELD_ELEMENTS} elements; {kernel_ms:.6f} ms from a CUDA "
              f"graph through the wrapper, {alone_ms:.6f} ms the kernel "
              f"alone, bound {bound_ms:.6f} ms by {bound_by}", flush=True)

    t0 = time.perf_counter()
    h_bits = torch.from_numpy(bls_cuda._H_EFF_BITS).to(CARD)
    # every size's points are the first n of the largest's, so one plain
    # call holds them all: the first LADDER_SIZES[1] rows and a sample
    pts = _ladder_points(LADDER_SIZES[-1])
    held = _hold_rows(LADDER_SIZES[-1], head=LADDER_SIZES[1])
    want = curve_torch.windowed_ladder(
        curve_torch.F2, tuple(c[held] for c in pts),
        h_bits.expand(len(held), -1))
    for n in LADDER_SIZES:
        got = bls381_cuda.g2_ladder(tuple(c[:n] for c in pts),
                                    h_bits.expand(n, -1))
        mine = held < n
        torch.cuda.synchronize()
        err = _max_err(tuple(c[held[mine]] for c in got),
                       tuple(c[mine] for c in want))
        max_err["bls381_g2"] = max(max_err["bls381_g2"], err)
        check(err == 0, f"bls381_g2 != plain at {n} points ({err})")
        print(f"bls381_g2: h_eff ladder == plain bit for bit at {n} points "
              f"({int(mine.sum())} rows held; {time.perf_counter() - t0:.6f}"
              f" s into the phase)", flush=True)

    for n in COFACTOR_SIZES:
        pt = _cofactor_points(n)
        rows = _hold_rows(n)
        got = bls381_cuda.clear_cofactor_g2(pt)
        plain = curve_torch.clear_cofactor_g2_plain(
            tuple(c[rows] for c in pt))
        old = bls381_cuda.g2_ladder(pt, h_bits.expand(n, -1))
        old_xy = _old_affine_g2(old)
        torch.cuda.synchronize()
        err = max(_max_err(tuple(c[rows] for c in got[:2]), plain[:2]),
                  _max_err(got[:2], old_xy))
        max_err["bls381_cofactor"] = max(max_err["bls381_cofactor"], err)
        check(err == 0 and torch.equal(got[2][rows], plain[2])
              and torch.equal(got[2], ft.fq2_is_zero(old[2])),
              f"bls381_cofactor != plain or ladder + normalization at {n} "
              f"points ({err})")
        check(n < 64 or got[2][-2:].tolist() == [True, True],
              "bls381_cofactor: the order-169 and infinity rows did not "
              "come out as infinity")
        print(f"bls381_cofactor: affine h_eff P == plain psi version "
              f"({len(rows)} rows held) == ladder + normalization (every "
              f"row) bit for bit at {n} points ({int(got[2].sum())} at "
              f"infinity; {time.perf_counter() - t0:.6f} s into the phase)",
              flush=True)

    for k in MILLER_SIZES:
        jobs = [_pairing_jobs(k, True), _pairing_jobs(k, False)]
        xp, yp, xq, yq = (torch.cat([j[c] for j in jobs]) for c in range(4))
        skip = torch.zeros(2 * k, dtype=torch.bool, device=CARD)
        f = bls381_cuda.miller(xp, yp, xq, yq, skip)
        prod, ok = bls381_cuda.product_final(f.reshape(2, k, 12, 32))
        want_f = pairing_torch.miller_loop(xp, yp, xq, yq, skip)
        want_prod, want_ok = pairing_torch.product_final(
            want_f.reshape(2, k, 12, 32))
        batch = (xp.reshape(2, k, 32), yp.reshape(2, k, 32),
                 xq.reshape(2, k, 2, 32), yq.reshape(2, k, 2, 32),
                 skip.reshape(2, k))
        new_prod, new_ok = bls381_cuda.pairing_check(*batch)
        plain_prod, plain_ok = pairing_torch.check_plain(*batch)
        torch.cuda.synchronize()
        err = max(_max_err(f, want_f), _max_err(prod, want_prod))
        max_err["bls381_pairing"] = max(max_err["bls381_pairing"], err)
        check(err == 0, f"bls381_pairing != plain at k = {k} ({err})")
        new_err = max(_max_err(new_prod, prod), _max_err(new_prod, plain_prod))
        max_err["bls381_check"] = max(max_err["bls381_check"], new_err)
        check(new_err == 0, f"bls381_check != miller + product_final or its "
              f"plain version at k = {k} ({new_err})")
        verdicts = [ok.tolist(), want_ok.tolist(), new_ok.tolist(),
                    plain_ok.tolist()]
        check(all(v == [True, False] for v in verdicts),
              f"pairing verdicts at k = {k} (old kernel, its plain version, "
              f"bls381_check, its plain version): {verdicts}, expected "
              f"[True, False]")
        print(f"bls381_pairing: Miller values and products == plain bit "
              f"for bit at k = {k}; bls381_check: the product before the "
              f"final exponentiation == miller + product_final == its plain "
              f"version bit for bit; verdicts [valid, invalid] == [True, "
              f"False] in all four ({time.perf_counter() - t0:.6f} s into "
              f"the phase)", flush=True)

    jobs = [_pairing_jobs(2, i % 2 == 0) for i in range(CHECK_JOBS)]
    batch = tuple(torch.stack([j[c] for j in jobs]) for c in range(4)) + (
        torch.zeros(CHECK_JOBS, 2, dtype=torch.bool, device=CARD),)
    new_prod, new_ok = bls381_cuda.pairing_check(*batch)
    f = bls381_cuda.miller(*(c.reshape((2 * CHECK_JOBS,) + c.shape[2:])
                             for c in batch))
    prod, ok = bls381_cuda.product_final(f.reshape(CHECK_JOBS, 2, 12, 32))
    plain_prod, plain_ok = pairing_torch.check_plain(*batch)
    torch.cuda.synchronize()
    err = max(_max_err(new_prod, prod), _max_err(new_prod, plain_prod))
    max_err["bls381_check"] = max(max_err["bls381_check"], err)
    expected = [True, False] * (CHECK_JOBS // 2)
    check(err == 0 and new_ok.tolist() == ok.tolist() == plain_ok.tolist()
          == expected, f"bls381_check at {CHECK_JOBS} jobs of k = 2: "
          f"err {err}, verdicts {new_ok.tolist()}")
    print(f"bls381_check: {CHECK_JOBS} jobs of k = 2 == miller + "
          f"product_final == its plain version bit for bit, verdicts "
          f"[True, False] x {CHECK_JOBS // 2}", flush=True)

    # the main path's shapes, old and new side by side: one check of two
    # pairs, one hashed message's cofactor clearing with its affine words
    times = {}
    xp, yp, xq, yq = _pairing_jobs(2, True)
    skip = torch.zeros(2, dtype=torch.bool, device=CARD)
    one_job = (xp[None], yp[None], xq[None], yq[None], skip[None])

    def check_once():
        f = bls381_cuda.miller(xp, yp, xq, yq, skip)
        return bls381_cuda.product_final(f.reshape(1, 2, 12, 32))

    def check_new():
        return bls381_cuda.pairing_check(*one_job)
    got = check_once()
    new = check_new()
    check(_max_err(new[0], got[0]) == 0 and bool(got[1][0])
          and bool(new[1][0]),
          "bls381_pairing and bls381_check at the main path's shape (both "
          "held against the plain version at k = 2 above)")
    # the pairing's launches are timed beside their plain version and
    # bound at the flush's shapes (pairing_launches); here only side by
    # side with the check
    two_launch_ms = graph_ms(check_once, 5)
    new_plain_ms, check_products = plain_products(
        lambda: pairing_torch.check_plain(*one_job))
    # the plain version multiplies each bit's two lines into f as two
    # dense Fq12 products; the bound counts them as sparse ones
    check_products -= 2 * (63 + _X_ONES) * (54 - LINE_PRODUCTS)
    times["bls381_check"] = (graph_ms(check_new, 5), new_plain_ms,
                             *op_bound(check_products, (2 * 72 + 144) * 4,
                                       n_sms, max_mhz))
    pt = _ladder_points(1)
    bits = h_bits.expand(1, -1)
    check(_max_err(bls381_cuda.g2_ladder(pt, bits), curve_torch
                   .windowed_ladder(curve_torch.F2, pt, bits)) == 0,
          "bls381_g2 at the main path's shape")
    ladder_products, ladder_chain = windowed_products(
        len(bls_cuda._H_EFF_BITS), G2_DOUBLE_PRODUCTS, G2_ADD_PRODUCTS)
    times["bls381_g2"] = (
        graph_ms(lambda: bls381_cuda.g2_ladder(pt, bits), 5),
        cuda_ms(lambda: curve_torch.windowed_ladder(curve_torch.F2, pt,
                                                    bits), 1, warmup=0),
        *op_bound(ladder_products,
                  (72 * 2 + len(bls_cuda._H_EFF_BITS) / 4) * 4,
                  n_sms, max_mhz))
    cleared = bls381_cuda.g2_ladder(pt, bits)

    def normalize_plain():
        X, Y, Z = cleared
        zinv = ft.fq2_inv(Z)
        zinv2 = ft.fq2_square(zinv)
        zinv3 = ft.fq2_mul(zinv2, zinv)
        return ft.fq2_mul(torch.stack([X, Y]), torch.stack([zinv2, zinv3]))
    got = torch.stack(_old_affine_g2(cleared))
    check(_max_err(got, normalize_plain()) == 0,
          "bls381_field at the main path's shape (affine normalization)")
    products = FQ2_INV + 2 + 3 + 2 * 3
    times["bls381_field"] = (
        graph_ms(lambda: _old_affine_g2(cleared), 5),
        cuda_ms(normalize_plain, 1),
        *op_bound(products, (24 * 2 + 24 * 2 + 24 * 3 + 24 * 6) * 4, n_sms,
                  max_mhz))
    new = bls381_cuda.clear_cofactor_g2(pt)
    check(_max_err(new[:2], got.unbind(0)) == 0 and not bool(new[2][0]),
          "bls381_cofactor at the main path's shape")
    cofactor_plain_ms, cofactor_plain_products = plain_products(
        lambda: curve_torch.clear_cofactor_g2_plain(pt))
    times["bls381_cofactor"] = (
        graph_ms(lambda: bls381_cuda.clear_cofactor_g2(pt), 5),
        cofactor_plain_ms,
        *op_bound(COFACTOR_METHOD_PRODUCTS, (72 + 48 + 48) * 4 + 1, n_sms,
                  max_mhz))
    for name, (ms, plain_ms, bound_ms, bound_by) in times.items():
        print(f"{name} at the main path's shape: {ms:.6f} ms from a CUDA "
              f"graph, plain torch {plain_ms:.6f} ms, bound {bound_ms:.6f} "
              f"ms by {bound_by}; no PyTorch call computes it, so no "
              f"library time")
    old_a = times["bls381_g2"][0] + times["bls381_field"][0]
    old_b = two_launch_ms
    print(f"side by side, one point: bls381_cofactor "
          f"{times['bls381_cofactor'][0]:.6f} ms against the ladder and the "
          f"4-launch normalization {old_a:.6f} ms "
          f"({old_a / times['bls381_cofactor'][0]:.2f}x); one check of "
          f"k = 2: bls381_check {times['bls381_check'][0]:.6f} ms against "
          f"miller + product_final {old_b:.6f} ms "
          f"({old_b / times['bls381_check'][0]:.2f}x)")
    print(f"products: bls381_cofactor {COFACTOR_METHOD_PRODUCTS} the "
          f"method's (its bound), {COFACTOR_PRODUCTS} the kernel's (with the "
          f"doublings its adds discard), {cofactor_plain_products} its plain "
          f"version's counter; bls381_check {check_products}, its plain "
          f"version's counter with its Fq inverse counted as the binary "
          f"GCD's one product and its line products as sparse ones (its "
          f"bound); the h_eff ladder {ladder_products}, its dependent chain "
          f"{ladder_chain}; dependent Fq product: "
          f"{times['bls381_cofactor'][0] * 1e6 / COFACTOR_PRODUCTS:.1f} ns "
          f"in bls381_cofactor (one thread), "
          f"{times['bls381_g2'][0] * 1e6 / ladder_chain:.1f} ns in the "
          f"ladder")
    return max_err, times


def _device_and_native(fn_name, *args):
    bls.use_backend("cuda")
    got = getattr(bls, fn_name)(*args)
    bls.use_backend("native")
    want = getattr(bls, fn_name)(*args)
    bls.use_backend("cuda")
    return got, want


@phase("bls")
def bls_phase():
    """Seeded cases through the shim's device backend, each verdict equal
    to the port's native oracle: Verify valid, tampered, wrong key and
    infinity; FastAggregateVerify over a 128-key committee, valid and
    invalid; AggregateVerify over 8 messages."""
    rng = random.Random(SEED + 7)
    sks, pks = consecutive_keys(FAV_COMMITTEE, rng.randrange(1, 2**128))
    msg = b"chip smoke message"
    sig = bls.Sign(sks[0], msg)
    other = bls.Sign(sks[0], b"another message")
    infinity_pk = b"\xc0" + b"\x00" * 47
    cases = {
        "Verify valid": ("Verify", pks[0], msg, sig, True),
        "Verify tampered": ("Verify", pks[0], msg, other, False),
        "Verify wrong key": ("Verify", pks[1], msg, sig, False),
        "Verify infinity pubkey": ("Verify", infinity_pk, msg, sig, False),
    }
    agg = bls12_381.Sign(sum(sks) % R, msg)
    cases["FastAggregateVerify 128 keys valid"] = (
        "FastAggregateVerify", pks, msg, agg, True)
    cases["FastAggregateVerify 128 keys invalid"] = (
        "FastAggregateVerify", pks[:-1] + [pks[0]], msg, agg, False)
    msgs = [bytes([i]) * 32 for i in range(AV_MESSAGES)]
    av_sig = bls.Aggregate([bls.Sign(sk, m)
                            for sk, m in zip(sks[:AV_MESSAGES], msgs)])
    cases[f"AggregateVerify {AV_MESSAGES} messages"] = (
        "AggregateVerify", pks[:AV_MESSAGES], msgs, av_sig, True)
    plain = [w.plain_calls for ws in bls381_cuda.WRAPPERS.values()
             for w in ws]
    for name, (fn, pk, m, s, expected) in cases.items():
        t0 = time.perf_counter()
        got, want = _device_and_native(fn, pk, m, s)
        check(got is want is expected,
              f"bls {name}: device {got}, native {want}, expected "
              f"{expected}")
        print(f"bls {name}: {got} on the device backend == native oracle "
              f"({time.perf_counter() - t0:.6f} s both)", flush=True)
    check([w.plain_calls for ws in bls381_cuda.WRAPPERS.values()
           for w in ws] == plain, "bls: a wrapper took its plain version")


class HostClock:
    """Host clocks around functions, wrapped in place on their owner (a
    module, a launcher namespace, or an instance for its methods): the
    seconds and calls of each label; `sync` times a call to a
    synchronize of the card."""

    def __init__(self):
        self.seconds = {}
        self.calls = {}
        self._saved = []

    def _wrap(self, label, owner, name, instance=False, sync=False):
        fn = getattr(owner, name)

        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            self.seconds[label] = self.seconds.get(label, 0.0) \
                + time.perf_counter() - t0
            self.calls[label] = self.calls.get(label, 0) + 1
            return out
        self._saved.append((owner, name, None if instance else fn))
        setattr(owner, name, run)

    def close(self):
        for owner, name, fn in reversed(self._saved):
            if fn is None:
                delattr(owner, name)
            else:
                setattr(owner, name, fn)


class BlockRecorder(HostClock):
    """Host clocks around the parts of a block's transition: the committee
    scans (every `get_active_validator_indices` call), host decode (point
    decompression and subgroup checks), hash-to-field with SSWU and the
    isogeny, and the card's BLS work (the cofactor clearing and the
    pairing check, each from its launch to a synchronize); with the signature
    pipeline on, the collection of the block's sets (its committee scans
    inside it), the committee sums and the one-launch fold (its host
    hash-to-field inside it)."""

    def __init__(self, spec):
        super().__init__()
        self._wrap("committee scans", spec, "get_active_validator_indices",
                   instance=True)
        for name in ("_resolve_pubkey", "_resolve_signature"):
            self._wrap("host decode", bls_cuda, name)
        for name in ("hash_to_field_fq2", "sswu_map", "iso_map"):
            self._wrap("hash-to-field, SSWU, isogeny", h2c, name)
        # both kernels at their launchers, a launch to its synchronize (a
        # wrapper counts launches on its own module attribute, so it is
        # not patched)
        launchers = cuda_build.build()
        self._wrap("card: cofactor clearing", launchers, "clear_cofactor",
                   sync=True)
        self._wrap("card: pairing checks", launchers, "pairing_check",
                   sync=True)
        self._wrap("hash_to_g2_batch", bls_cuda, "hash_to_g2_batch")
        self._wrap("process_slots", spec, "process_slots", instance=True)
        # the signature pipeline's parts
        self._wrap("collection", sig_sets, "collect_block_sets")
        self._wrap("host decode", sig_cache, "_load_pubkey")
        self._wrap("host decode", sig_scheduler, "_load_signature")
        self._wrap("card: committee sums", g1_sweep, "g1_add_sweep",
                   sync=True)
        self._wrap("card: fold flush", shard_verify, "pairing_fold",
                   sync=True)


def _bls_counts():
    return {name: sum(w.launches for w in ws)
            for name, ws in bls381_cuda.WRAPPERS.items()}


def _reset_bls_counts():
    for ws in bls381_cuda.WRAPPERS.values():
        for w in ws:
            w.launches = 0


@phase("block")
def block_phase():
    """The block path: `block_case` at 262,144 validators (a signed block
    at slot 98 with 8 full-committee attestations, a proposer and an
    attester slashing: 14 signature checks) through `state_transition`
    with BLS on and the device backend.  The root must equal the host
    oracle and the JAX package's; every check must launch the cofactor
    kernel once and the four-warp pairing check once, and the kernels they
    replace (the ladder, the field kernel, the pairing kernel's two
    launches) never; a copy whose first attestation carries the wrong
    signature must be rejected there."""
    spec = get_spec("phase0", "mainnet")
    merkle.use_device_hashing()
    t0 = time.perf_counter()
    state, signed, facts = block_case(spec, N_VALIDATORS)
    n_checks = len(facts["committees"]) + 6
    print(f"block: pre-state of {N_VALIDATORS} validators with "
          f"{facts['signers']} signers' keys and a block of "
          f"{len(facts['committees'])} attestations (committees "
          f"{facts['committees'][:2]}...), {n_checks} signature checks, "
          f"built in {time.perf_counter() - t0:.6f} s (its state root from "
          f"one transition of a copy with BLS off)", flush=True)
    tampered_pre = state.copy()
    sigpipe_pre = state.copy()
    sigpipe_tampered_pre = state.copy()
    bls.use_backend("cuda")
    bls.bls_active = True
    plain = [w.plain_calls for ws in bls381_cuda.WRAPPERS.values()
             for w in ws]
    rec = BlockRecorder(spec)
    try:
        _reset_bls_counts()
        t0 = time.perf_counter()
        spec.state_transition(state, signed)
        torch.cuda.synchronize()
        block_s = time.perf_counter() - t0
        launches = _bls_counts()
        per_wrapper = {w.__name__: w.launches
                       for ws in bls381_cuda.WRAPPERS.values() for w in ws}
    finally:
        rec.close()
    check([w.plain_calls for ws in bls381_cuda.WRAPPERS.values()
           for w in ws] == plain, "block: a wrapper took its plain version")
    root = bytes(spec.hash_tree_root(state))
    oracle = host_oracle(state)
    check(root == oracle, f"block: root {root.hex()} != host-hashed oracle "
          f"{oracle.hex()}")
    check(root.hex() == POST_BLOCK_ROOT_98,
          f"block: root {root.hex()} != the JAX package's "
          f"{POST_BLOCK_ROOT_98}")
    hashes = rec.calls.get("hash_to_g2_batch", 0)
    checks = rec.calls.get("card: pairing checks", 0)
    check(hashes == checks == n_checks,
          f"block: {hashes} hash-to-G2 calls and {checks} pairing checks, "
          f"expected {n_checks}")
    check(per_wrapper["clear_cofactor_g2"] == hashes
          and per_wrapper["pairing_check"] == checks,
          f"block: {per_wrapper['clear_cofactor_g2']} cofactor and "
          f"{per_wrapper['pairing_check']} pairing-check launches for "
          f"{hashes} hash-to-G2 calls and {checks} checks")
    replaced = ("g2_ladder", "field_op", "miller", "product_final")
    check(all(per_wrapper[name] == 0 for name in replaced),
          f"block: a replaced kernel was launched: {per_wrapper}")
    sec = rec.seconds
    card_s = sec.get("card: cofactor clearing", 0) \
        + sec.get("card: pairing checks", 0)
    print(f"block: state_transition {block_s:.6f} s with BLS on: "
          f"process_slots 97 -> 98 {sec.get('process_slots', 0):.6f} s, "
          f"committee scans {sec.get('committee scans', 0):.6f} s "
          f"({rec.calls.get('committee scans', 0)} scans of the registry), "
          f"host decode {sec.get('host decode', 0):.6f} s "
          f"({rec.calls.get('host decode', 0)} points), hash-to-field with "
          f"SSWU and isogeny "
          f"{sec.get('hash-to-field, SSWU, isogeny', 0):.6f} s, card: "
          f"{card_s:.6f} s (cofactor clearing "
          f"{sec.get('card: cofactor clearing', 0):.6f} s, pairing checks "
          f"{sec.get('card: pairing checks', 0):.6f} s)")
    print(f"block: launches {per_wrapper} ({n_checks} signature checks)")
    print(f"block: root at slot {BLOCK_SLOT} {root.hex()} == host oracle == "
          f"JAX package")

    bad = tampered_block(spec, signed, facts)
    t0 = time.perf_counter()
    try:
        spec.state_transition(tampered_pre, bad)
    except AssertionError as err:
        frames = [f.name for f in traceback.extract_tb(err.__traceback__)]
        check(frames[-1] == "process_attestation",
              f"block: tampered copy rejected at {frames[-3:]}")
        print(f"block: the copy with a tampered first attestation is "
              f"rejected at process_attestation "
              f"({time.perf_counter() - t0:.6f} s)")
    else:
        check(False, "block: the tampered copy was accepted")
    sig_launches = sigpipe_block(spec, sigpipe_pre, sigpipe_tampered_pre,
                                 signed, bad, n_checks)
    return launches, sig_launches


def sigpipe_block(spec, state, tampered_pre, signed, bad, n_checks):
    """The same block with `sigpipe.enable()`: one flush of its checks on
    the card (the committee sums, the one-launch fold), the seams reading
    its verdicts.  The root must equal the host oracle and the JAX
    package's, every check must hit the verdict map, the flush must be one
    fold chain with no scalar check's ladder and no plain version, and
    the tampered copy must be rejected at its attestation after
    bisection.  Returns the BLS kernels' launches of the valid block."""
    plain = _plain_counts()
    sig_cache.clear()
    METRICS.reset()
    sigpipe.enable()
    rec = BlockRecorder(spec)
    try:
        _reset_bls_counts()
        t0 = time.perf_counter()
        spec.state_transition(state, signed)
        torch.cuda.synchronize()
        block_s = time.perf_counter() - t0
        launches = _flush_counts()
        per_kernel = _bls_counts()
        snap = METRICS.snapshot()
    finally:
        rec.close()
        sigpipe.disable()
    check(_plain_counts() == plain,
          "sigpipe block: a wrapper took its plain version")
    root = bytes(spec.hash_tree_root(state))
    oracle = host_oracle(state)
    check(root == oracle and root.hex() == POST_BLOCK_ROOT_98,
          f"sigpipe block: root {root.hex()}, host oracle {oracle.hex()}, "
          f"the JAX package's {POST_BLOCK_ROOT_98}")
    check(snap.get("seam_hits") == n_checks
          and snap.get("seam_misses", 0) == 0,
          f"sigpipe block: {snap.get('seam_hits')} seam hits and "
          f"{snap.get('seam_misses', 0)} misses, expected {n_checks} and 0")
    check(launches["fold_lanes"] == bls381_cuda.FOLD_LAUNCHES
          and launches["clear_cofactor_g2"] >= 1
          and launches["segment_sum"] >= 1
          and launches["g2_ladder"] == 0 and launches["miller"] == 1
          and launches["product_final"] == 2,
          f"sigpipe block: launches {launches}, expected one fold chain "
          f"and no scalar check")
    check(snap["miller_loops_per_flush"]["total"] == n_checks + 1,
          f"sigpipe block: {snap['miller_loops_per_flush']} legs")
    sec, calls = rec.seconds, rec.calls
    print(f"sigpipe block: state_transition {block_s:.6f} s with BLS on "
          f"and the pipeline on: process_slots 97 -> 98 "
          f"{sec.get('process_slots', 0):.6f} s, collection of "
          f"{snap['signatures_scheduled']} sets "
          f"{sec.get('collection', 0):.6f} s, committee scans "
          f"{sec.get('committee scans', 0):.6f} s "
          f"({calls.get('committee scans', 0)} scans of the registry), host "
          f"decode {sec.get('host decode', 0):.6f} s "
          f"({calls.get('host decode', 0)} points), the flush "
          f"{snap['verify_sets_sec']:.6f} s: card: committee sums "
          f"{sec.get('card: committee sums', 0):.6f} s, fold flush "
          f"{sec.get('card: fold flush', 0):.6f} s (of which hash-to-field "
          f"with SSWU and isogeny "
          f"{sec.get('hash-to-field, SSWU, isogeny', 0):.6f} s)")
    print(f"sigpipe block: {snap['seam_hits']} seam hits, 0 misses, "
          f"{snap['miller_loops_per_flush']['total']} Miller legs in one "
          f"flush; launches {launches}")
    print(f"sigpipe block: root at slot {BLOCK_SLOT} {root.hex()} == host "
          f"oracle == JAX package")

    METRICS.reset()
    sigpipe.enable()
    t0 = time.perf_counter()
    try:
        spec.state_transition(tampered_pre, bad)
    except AssertionError as err:
        frames = [f.name for f in traceback.extract_tb(err.__traceback__)]
        check(frames[-1] == "process_attestation",
              f"sigpipe block: tampered copy rejected at {frames[-3:]}")
        check(METRICS.count("fused_batch_failures") == 1,
              "sigpipe block: the tampered flush did not fail")
        print(f"sigpipe block: the copy with a tampered first attestation "
              f"is rejected at process_attestation after "
              f"{METRICS.count('bisect_dispatches')} bisection probes "
              f"({time.perf_counter() - t0:.6f} s)")
    else:
        check(False, "sigpipe block: the tampered copy was accepted")
    finally:
        sigpipe.disable()
    return per_kernel


# ---------------------------------------------------------------------------
# the signature flush: its kernels and scheduler.verify_sets
# ---------------------------------------------------------------------------

FLUSH_COMMITTEES = (1, 2, 4, 1)   # the pubkeys of set i: [i % 4]
FLUSH_ROOTS = 16                  # distinct signing roots a flush
FLUSH_SK_BASE = 0x5EED5000        # the first signer's secret key
FLUSH_SIZES = (16, 256)           # sets a flush in phase "flush"
FLUSH_BAD = 8                     # the bad set of the 16-set flush
ORACLE_SAMPLE = 16                # sets of a larger flush the oracle checks
K1_BLOCK = (8, 128)               # a phase0 block's committee sums
K1_RAGGED = (64, 2048)            # ragged lists up to MAX_VALIDATORS_PER_COMMITTEE
K1_G2 = 1024                      # one G2 segment (a flush's signature sum)
K1_FOLD = (14, 16)                # the block fold's signature sum: 14 live of 16
K1_BLOB = (6, 8)                  # the blob verify's lincomb sum: 6 live of 8
K1_PLAIN_SEGMENTS = 8             # plain halving segments a call on the card
K2_SIZES = (1024, 16384)
K2_SAMPLE = 1024                  # rows of a larger K2 run the plain version holds
K2_TIMED = 256                    # a full block's weighting sweep
K2_BLOB = (6, 8)                  # the blob verify's lincomb: points, rows
K2_SPLIT_SIZES = (K2_BLOB[1], 1024)   # K2's holds at split 256-bit rows
# the GLV split's edge scalars (s0 or s1 at 0 or its top)
GLV_EDGES = (0, 1, curve_torch.GLV_LAMBDA - 1, curve_torch.GLV_LAMBDA,
             2**128, R - curve_torch.GLV_LAMBDA, R - 1)
K4_SIZES = ((14, 16), (256, 256))  # (sets, lanes): the block's flush pads
K4_ORACLE = 1024
G1_DOUBLE_PRODUCTS, G1_ADD_PRODUCTS = 7, 16
G1_MIXED_ADD_PRODUCTS = 11        # Jacobian + affine (Z = 1): 7M + 4S
# affine words, each inverse counted as GCD_FQ_INV (as in the psi leg's
# COFACTOR_METHOD_PRODUCTS), whatever inverse the kernel computes
AFFINE_G1 = GCD_FQ_INV + 4        # inverse, square, three products
AFFINE_G2 = 4 + GCD_FQ_INV + 2 + 3 * 3


def ladder_products(bits, double, add):
    """Fq products of msb-first ladders over the rows of `bits` (numpy
    [n, nbits]): a doubling a bit, an add a set bit but the first (which
    lands on infinity and returns at once)."""
    ones = bits.sum(axis=1)
    return int(bits.shape[0] * bits.shape[1] * double
               + np.maximum(ones - 1, 0).sum() * add)


def windowed_products(nbits, double, add, split=False):
    """(products, chain) of one live row of the windowed ladder
    (csrc/bls381_ladder.cuh) over nbits bits (each half's on a split row),
    with `double` and `add` Fq products a doubling and an add.  Products:
    the table's w - 1 doublings and 2^(w-1) - 1 adds, then (m - 1) windows
    of w doublings and an add and the even correction's add; a split row
    runs two such chains beside the phi level's 2^(w-1) products and the
    join.  Chain, the dependent part: the table's levels (a doubling, then
    w - 1 adds), a lane's two phi products, one chain and the join."""
    w = curve_torch.LADDER_W
    m = max(1, -(-nbits // w))
    one = (m - 1) * (w * double + add) + add
    table = (w - 1) * double + ((1 << (w - 1)) - 1) * add
    levels = double + (w - 1) * add
    if split:
        return (table + (1 << (w - 1)) + 2 * one + add,
                levels + 2 + one + add)
    return table + one, levels + one


def _live_rows(pt, scalars):
    """Rows of a ladder run whose work the bound counts: a point not at
    infinity and a scalar not 0."""
    inf = (pt[2].reshape(pt[2].shape[0], -1) == 0).all(dim=1).cpu()
    return sum(1 for i, s in zip(inf.tolist(), scalars) if not i and s)


def _blob_rows():
    """K2's rows at the blob verify's shape: 6 seeded points of G1 with
    seeded 255-bit scalars below r, padded to 8 with infinity and scalar
    0, as `g1_multi_exp` pads them, split by GLV: (pt, bits [8, 2, 128],
    scalars)."""
    live, rows = K2_BLOB
    pt = tuple(c[:, 0] for c in _segments(
        "g1", [1] * live + [0] * (rows - live), 1))
    rng = np.random.default_rng([SEED, 17])
    scal = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(live)]
    scal += [0] * (rows - live)
    return pt, curve_torch.glv_bits(scal, CARD), scal


def flush_case(n, bad=()):
    """`_flush_case`, built once for each n and bad set (seconds of host
    arithmetic at 256 and 1,024 sets)."""
    return _flush_case(n, tuple(bad))


@functools.lru_cache(maxsize=None)
def _flush_case(n, bad):
    """n seeded signature sets of FLUSH_ROOTS roots: set i signs root
    i % 16 with the keys FLUSH_SK_BASE + ... (a committee of
    FLUSH_COMMITTEES[i % 4] consecutive keys, its signature Sign(sum of
    keys)); a set in `bad` signs with the sum plus one.  Returns (sets,
    aggregate G1 points, signature G2 points, seeded 64-bit
    coefficients)."""
    rng = np.random.default_rng([SEED, 9, n])
    g1 = cv.g1_generator()
    roots = [rng.bytes(32) for _ in range(FLUSH_ROOTS)]
    hashes = [h2c.hash_to_g2(r) for r in roots]
    sets, aggs, sigs = [], [], []
    sk = FLUSH_SK_BASE
    point = g1 * sk
    for i in range(n):
        size = FLUSH_COMMITTEES[i % len(FLUSH_COMMITTEES)]
        pks, agg = [], cv.g1_infinity()
        for _ in range(size):
            pks.append(cv.g1_to_bytes(point))
            agg = agg + point
            point = point + g1
        total = size * sk + size * (size - 1) // 2
        sk += size
        sig = hashes[i % FLUSH_ROOTS] * (total + (1 if i in bad else 0))
        sets.append(SignatureSet(
            pubkeys=tuple(pks), signing_root=roots[i % FLUSH_ROOTS],
            signature=cv.g2_to_bytes(sig), kind="attestation",
            origin=("attestation", i)))
        aggs.append(agg)
        sigs.append(sig)
    coeffs = [int(c) for c in rng.integers(1, 2**63, n, dtype=np.uint64)]
    return sets, aggs, sigs, coeffs


def _with_bad_signature(inputs, sigs):
    """The fold's inputs with set FLUSH_BAD's signature moved off by G2 (a
    valid point, the wrong signature)."""
    aggP, cbits, hP, sP = inputs
    row = curve_torch.g2_pack([sigs[FLUSH_BAD] + cv.g2_generator()], CARD)
    bad = tuple(c.clone() for c in sP)
    for c, r in zip(bad, row):
        c[FLUSH_BAD] = r[0]
    return aggP, cbits, hP, bad


def native_verdicts(sets, indices):
    return {i: bls12_381.FastAggregateVerify(
        list(sets[i].pubkeys), sets[i].signing_root, sets[i].signature)
        for i in indices}


def _plain_halving(F, pt):
    """bls381_cuda.halving_sum on the card, K1_PLAIN_SEGMENTS segments a
    call (bounds the plain products' intermediates)."""
    outs = [bls381_cuda.halving_sum(F, tuple(
        c[i:i + K1_PLAIN_SEGMENTS] for c in pt))
        for i in range(0, pt[0].shape[0], K1_PLAIN_SEGMENTS)]
    return tuple(torch.cat(c) for c in zip(*outs))


def _segments(group, lengths, width):
    """Jacobian limbs on the card, [len(lengths), width] points: segment j
    a run of lengths[j] consecutive multiples of the generator from a
    seeded start, padded with infinity."""
    rng = np.random.default_rng([SEED, 10, width, len(lengths)])
    gen = cv.g1_generator() if group == "g1" else cv.g2_generator()
    inf = cv.g1_infinity() if group == "g1" else cv.g2_infinity()
    flat = []
    for n in lengths:
        p = gen * int(rng.integers(1, 2**62))
        for _ in range(n):
            flat.append(p)
            p = p + gen
        flat.extend([inf] * (width - n))
    pack = curve_torch.g1_pack if group == "g1" else curve_torch.g2_pack
    return tuple(c.reshape((len(lengths), width) + c.shape[1:])
                 for c in pack(flat, CARD))


def k1_levels(width, g2=False):
    """(chain, passes) of a K1 segment of `width` points: its dependent Fq
    products (five levels a round, csrc/bls381_segment.cuh) and the level
    passes its batches take (SEG_BATCH_G1 32 or SEG_BATCH_G2 10 adds a
    batch, a level's products or Karatsuba parts over 128 lanes)."""
    parts = (12, 12, 7, 6, 6) if g2 else (5, 4, 3, 2, 2)
    batch = 10 if g2 else 32
    passes, h = 0, width // 2
    while h >= 1:
        for b0 in range(0, h, batch):
            nb = min(batch, h - b0)
            passes += sum(-(-p * nb // 128) for p in parts)
        h //= 2
    return 5 * int(math.log2(width)), passes


def _fold_chain_plain(aggP, cbits, hP, sP):
    """The plain versions of the fold's chain on the card: the lanes, the
    Miller loops and their product without the final exponentiation."""
    hbits = pairing_torch._h_eff_bits(CARD)
    pairs = pairing_torch._fold_lanes_plain(
        aggP, cbits, hP, sP, hbits, pairing_torch._fold_consts(CARD))
    f = pairing_torch.miller_loop(*pairs)
    return pairs, pairing_torch.product_final(f[None], final=False)[0][0]


def fold_products(k, n_sets, bits):
    """Fq products of the fold's lanes, sum and tail at k lanes, n_sets of
    them live, over the coefficient bit rows `bits` (numpy [k, 64]): the
    two 64-bit ladders, the cofactor by the psi method with its affine
    words (COFACTOR_METHOD_PRODUCTS), w's affine words, the signature
    sum's adds and S's affine words."""
    live = bits[:n_sets]
    lanes = (ladder_products(live, G1_DOUBLE_PRODUCTS, G1_ADD_PRODUCTS)
             + ladder_products(live, G2_DOUBLE_PRODUCTS, G2_ADD_PRODUCTS)
             + n_sets * (AFFINE_G1 + COFACTOR_METHOD_PRODUCTS))
    return lanes + (n_sets - 1) * G2_ADD_PRODUCTS + AFFINE_G2


def _legs_against_host(pairs, aggs, coeffs, pre, sigs):
    """How many of the fold's k + 1 legs on the card differ from the
    host's: (c_i agg_i, h_eff Q_i) and (-g1, sum_i c_i sig_i), affine, over
    Python ints (a leg with an infinity side must come out skipped)."""
    xp, yp, xq, yq, skip = (t.cpu() for t in pairs)
    cleared = {}
    S = cv.g2_infinity()
    want = []
    for agg, c, q, sig in zip(aggs, coeffs, pre, sigs):
        qa = q.affine()
        key = (qa[0].c0, qa[0].c1, qa[1].c0, qa[1].c1)
        if key not in cleared:
            cleared[key] = q * h2c.H_EFF
        S = S + sig * c
        want.append((agg * c, cleared[key]))
    want.append((-cv.g1_generator(), S))
    got = zip(zip(fq.unpack_mont(xp), fq.unpack_mont(yp)),
              zip(ft.fq2_unpack_mont(xq), ft.fq2_unpack_mont(yq)),
              skip.tolist())
    wrong = 0
    for (gp, gq, skipped), (w, h) in zip(got, want):
        if w.is_infinity() or h.is_infinity():
            wrong += not skipped
            continue
        (wx, wy), (hx, hy) = w.affine(), h.affine()
        wrong += skipped or gp != (wx.v, wy.v) or (
            (gq[0].c0, gq[0].c1, gq[1].c0, gq[1].c1)
            != (hx.c0, hx.c1, hy.c0, hy.c1))
    return wrong


@phase("flush kernels")
def flush_kernels_phase(n_sms, max_mhz):
    """The flush's kernels against their plain torch versions on the card,
    bit for bit: K1 (segment sums) on G1 at a block's 8 x 128, 64 ragged
    segments up to 2,048 and the blob verify's 6 of 8, on G2 at one
    segment of 1,024 and the block fold's 14 of 16; K2 (the G1
    ladder) at 1,024 and 16,384 lanes of 64 bits (the larger on a seeded
    sample of K2_SAMPLE rows) and at K2_SPLIT_SIZES rows split by GLV
    (the blob verify's 8, and 1,024 led by GLV_EDGES); the G2 ladder at
    the staged flush's 16 rows of 64 bits, alone and with K1; K4 (the
    fold's legs, with its K1 and its tail) and the Miller product after
    it at k = 16 (14 sets and two padded rows) and 256, valid and with
    one bad set.  At k = 1,024 the verdict and the 1,025 legs against the
    host's integer arithmetic.  Then the times of the block's
    shapes, of K1 at its three paths' and of K2 at the blob verify's from a
    CUDA graph (K1's with its dependent chain and level passes), beside the
    plain versions' and the operation bounds (K4's with its cofactor
    counted by the psi method, the ladders' by their windowed method),
    K4's longest leg, the cofactor kernel on the flush's hash points,
    alone, and the pairing kernel's launches (pairing_launches)."""
    max_err = {"bls381_segment_sum": 0, "bls381_g1_ladder": 0,
               "bls381_fold": 0, "bls381_pairing": 0, "bls381_g2": 0}
    t0 = time.perf_counter()
    cases = {"G1 8 x 128": ("g1", [K1_BLOCK[1]] * K1_BLOCK[0],
                            K1_BLOCK[1])}
    rng = np.random.default_rng([SEED, 11])
    ragged = [int(x) for x in rng.integers(0, K1_RAGGED[1], K1_RAGGED[0])]
    ragged[:3] = [K1_RAGGED[1], 1, 0]
    cases[f"G1 {K1_RAGGED[0]} ragged up to {K1_RAGGED[1]}"] = (
        "g1", ragged, K1_RAGGED[1])
    cases[f"G2 1 x {K1_G2}"] = ("g2", [K1_G2], K1_G2)
    cases[f"G2 1 x {K1_FOLD[1]}"] = ("g2", [K1_FOLD[0]], K1_FOLD[1])
    cases[f"G1 1 x {K1_BLOB[1]}"] = ("g1", [K1_BLOB[0]], K1_BLOB[1])
    segs = {}
    for name, (group, lengths, width) in cases.items():
        pt = _segments(group, lengths, width)
        F = curve_torch.F1 if group == "g1" else curve_torch.F2
        got = bls381_cuda.segment_sum(pt)
        want = _plain_halving(F, pt)
        torch.cuda.synchronize()
        err = _max_err(got, want)
        max_err["bls381_segment_sum"] = max(max_err["bls381_segment_sum"],
                                            err)
        check(err == 0, f"segment_sum {name} != plain ({err})")
        print(f"bls381_segment_sum {name}: == plain bit for bit "
              f"({time.perf_counter() - t0:.6f} s into the phase)",
              flush=True)
        segs[name] = pt

    # the first K2_SIZES[0] rows' points, repeated: rows are independent,
    # and building 16,384 distinct points on the host took 30-40 s
    base = tuple(c[:, 0] for c in _segments("g1", [1] * K2_SIZES[0], 1))
    for n in K2_SIZES:
        pt = tuple(c.repeat(n // K2_SIZES[0], 1) for c in base)
        scal = [int(c) for c in np.random.default_rng([SEED, 12, n]).integers(
            0, 2**63, n, dtype=np.uint64) * 2 + 1]
        bits = curve_torch.scalars_to_bits(scal, 64, CARD)
        got = bls381_cuda.g1_ladder(pt, bits)
        # the plain version on every row up to K2_SAMPLE, else on a seeded
        # sample of K2_SAMPLE rows
        rows = torch.arange(n, device=CARD) if n <= K2_SAMPLE else \
            torch.from_numpy(np.sort(np.random.default_rng(
                [SEED, 14, n]).choice(n, K2_SAMPLE, replace=False))).to(CARD)
        want = curve_torch.windowed_ladder(
            curve_torch.F1, tuple(c[rows] for c in pt), bits[rows])
        torch.cuda.synchronize()
        err = _max_err(tuple(c[rows] for c in got), want)
        max_err["bls381_g1_ladder"] = max(max_err["bls381_g1_ladder"], err)
        check(err == 0, f"g1_ladder != plain at {n} lanes ({err})")
        print(f"bls381_g1_ladder: == plain bit for bit at {n} lanes of 64 "
              f"bits ({'every row' if n <= K2_SAMPLE else f'{K2_SAMPLE} seeded rows'}; "
              f"{time.perf_counter() - t0:.6f} s into the phase)",
              flush=True)
    # rows split by GLV: the blob verify's 8 rows, and K2_SPLIT_SIZES[1]
    # rows whose first scalars are the split's edges (every row held; the
    # edge rows and the blob's also against the host oracle's multiples)
    for n in K2_SPLIT_SIZES:
        if n == K2_BLOB[1]:
            pt, bits, scal = _blob_rows()
        else:
            pt = tuple(c[:, 0] for c in _segments("g1", [1] * n, 1))
            rng = np.random.default_rng([SEED, 18, n])
            scal = [int.from_bytes(rng.bytes(32), "big") % R
                    for _ in range(n)]
            scal[:len(GLV_EDGES)] = GLV_EDGES
            bits = curve_torch.glv_bits(scal, CARD)
        got = bls381_cuda.g1_ladder(pt, bits)
        want = curve_torch.glv_ladder(pt, bits)
        torch.cuda.synchronize()
        err = _max_err(got, want)
        max_err["bls381_g1_ladder"] = max(max_err["bls381_g1_ladder"], err)
        check(err == 0, f"g1_ladder != plain at {n} split rows ({err})")
        head = min(n, K2_BLOB[1] + len(GLV_EDGES))
        pts = curve_torch.g1_unpack(tuple(c[:head].cpu() for c in pt))
        out = curve_torch.g1_unpack(tuple(c[:head].cpu() for c in got))
        check(out == [p * s for p, s in zip(pts, scal)],
              f"g1_ladder at {n} split rows != the host oracle")
        print(f"bls381_g1_ladder: == plain bit for bit at {n} rows split by "
              f"GLV (every row; the first {head} == the host oracle; "
              f"{time.perf_counter() - t0:.6f} s into the phase)",
              flush=True)

    fold_in = {}
    for n_sets, k in K4_SIZES:
        _sets, aggs, sigs, coeffs = flush_case(n_sets)
        valid = shard_verify.fold_inputs(
            aggs, coeffs, [s.signing_root for s in _sets], sigs)
        fold_in[k] = valid
        check(valid[0][0].shape[0] == k, f"fold at {n_sets} sets: "
              f"{valid[0][0].shape[0]} lanes, expected {k}")
        for bad in (False, True):
            inputs = _with_bad_signature(valid, sigs) if bad else valid
            got = pairing_torch.fold_partial_products(*inputs)
            _prod, ok = bls381_cuda.product_final(got[None, None])
            pairs_plain, want = _fold_chain_plain(*inputs)
            pairs = bls381_cuda.fold_lanes(
                *inputs, pairing_torch._fold_consts(CARD))
            torch.cuda.synchronize()
            err = max(_max_err(got, want), _max_err(pairs, pairs_plain))
            max_err["bls381_fold"] = max(max_err["bls381_fold"], err)
            check(err == 0, f"fold at k = {k} != plain ({err})")
            check(bool(ok[0]) == (not bad),
                  f"fold at k = {k}: verdict {bool(ok[0])}, bad {bad}")
            print(f"bls381_fold: lanes and partial product == plain bit "
                  f"for bit at k = {k} ({n_sets} sets), verdict "
                  f"{bool(ok[0])} ({'one bad set' if bad else 'valid'}; "
                  f"{time.perf_counter() - t0:.6f} s into the phase)",
                  flush=True)

    _sets, aggs, sigs, coeffs = flush_case(K4_ORACLE)
    valid = shard_verify.fold_inputs(
        aggs, coeffs, [s.signing_root for s in _sets], sigs)
    pairs = bls381_cuda.fold_lanes(*valid, pairing_torch._fold_consts(CARD))
    pre = curve_torch.g2_unpack(tuple(c.cpu() for c in valid[2]))
    wrong = _legs_against_host(pairs, aggs, coeffs, pre, sigs)
    check(wrong == 0, f"fold at k = {K4_ORACLE}: {wrong} legs differ from "
          f"the host's")
    for bad in (False, True):
        inputs = _with_bad_signature(valid, sigs) if bad else valid
        ok = pairing_torch.fq12_product_is_one(
            pairing_torch.fold_partial_products(*inputs)[None])
        check(ok == (not bad), f"fold at k = {K4_ORACLE}: verdict {ok}, "
              f"bad {bad}")
        print(f"bls381_fold at k = {K4_ORACLE}: "
              f"{'' if bad else f'{K4_ORACLE + 1} legs == the host integer arithmetic, '}"
              f"verdict {ok} ({'one bad set' if bad else 'valid'}; "
              f"{time.perf_counter() - t0:.6f} s into the phase)", flush=True)

    # times at the block's shapes: its committee sums, a full block's
    # weighting sweep, its flush's fold (14 sets, 16 lanes)
    times = {}
    pts = _segments("g1", [1] * K2_TIMED, 1)
    pt1 = tuple(c[:, 0] for c in pts)
    scal = [int(c) for c in np.random.default_rng([SEED, 13]).integers(
        1, 2**63, K2_TIMED, dtype=np.uint64)]
    bits = curve_torch.scalars_to_bits(scal, 64, CARD)
    k2_products, k2_chain = windowed_products(64, G1_DOUBLE_PRODUCTS,
                                              G1_ADD_PRODUCTS)
    times["bls381_g1_ladder"] = (
        graph_ms(lambda: bls381_cuda.g1_ladder(pt1, bits), 10),
        cuda_ms(lambda: curve_torch.windowed_ladder(curve_torch.F1, pt1,
                                                    bits), 1, warmup=0),
        *op_bound(_live_rows(pt1, scal) * k2_products,
                  K2_TIMED * (36 * 2 * 4 + 64), n_sms, max_mhz))
    # K2 at the blob verify's shape, through the wrapper and alone on
    # packed words
    blob_pt, blob_bits, blob_scal = _blob_rows()
    blob_words = bls381_cuda._words(torch.stack(blob_pt, dim=1))
    blob_bits8 = blob_bits.contiguous()
    blob_out = torch.empty_like(blob_words)
    k2_launch = cuda_build.build().g1_ladder
    blob_products, blob_chain = windowed_products(
        curve_torch.GLV_BITS, G1_DOUBLE_PRODUCTS, G1_ADD_PRODUCTS, split=True)
    blob = (graph_ms(lambda: bls381_cuda.g1_ladder(blob_pt, blob_bits), 10),
            graph_ms(lambda: k2_launch(blob_words, blob_bits8,
                                       curve_torch.GLV_BITS, blob_out,
                                       K2_BLOB[1], True), 10),
            cuda_ms(lambda: curve_torch.glv_ladder(blob_pt, blob_bits), 1,
                    warmup=0),
            *op_bound(_live_rows(blob_pt, blob_scal) * blob_products,
                      K2_BLOB[1] * (36 * 2 * 4 + 256), n_sms, max_mhz))
    n_sets, k = K4_SIZES[0]
    _sets, aggs, sigs, coeffs = flush_case(n_sets)
    inputs = shard_verify.fold_inputs(
        aggs, coeffs, [s.signing_root for s in _sets], sigs)
    hbits = pairing_torch._h_eff_bits(CARD)
    consts = pairing_torch._fold_consts(CARD)
    lane_bytes = (36 + 72 + 72 + 8) * 4 * k + 48 * 4 \
        + (24 + 48 + 1) * 4 * (k + 1)
    times["bls381_fold"] = (
        graph_ms(lambda: bls381_cuda.fold_lanes(*inputs, consts), 3),
        cuda_ms(lambda: pairing_torch._fold_lanes_plain(
            *inputs, hbits, consts), 1, warmup=0),
        *op_bound(fold_products(k, n_sets, inputs[1].cpu().numpy()),
                  lane_bytes, n_sms, max_mhz))
    hq = bls381_cuda._words(torch.stack(inputs[2], dim=1))
    psi = fq.to_words(curve_torch.psi_consts(CARD)).contiguous()
    h_xy = torch.empty((k, 2, 2, fq.WORDS), dtype=torch.int32, device=CARD)
    h_inf = torch.empty(k, dtype=torch.uint8, device=CARD)
    kernels = cuda_build.build()
    leg_ms = graph_ms(lambda: kernels.clear_cofactor(hq, psi, h_xy, h_inf,
                                                     k), 3)
    chain_ms = graph_ms(
        lambda: pairing_torch.fold_partial_products(*inputs), 3)
    verdict_ms = graph_ms(lambda: bls381_cuda.product_final(
        pairing_torch.fold_partial_products(*inputs)[None, None]), 3)
    g2_pts = _segments("g2", [1] * k, 1)
    g2_pt = tuple(c[:, 0] for c in g2_pts)
    g2_bits = curve_torch.scalars_to_bits(coeffs + [0] * (k - n_sets), 64,
                                          CARD)

    def mexp():
        return bls381_cuda.segment_sum(tuple(
            c[None] for c in bls381_cuda.g2_ladder(g2_pt, g2_bits)))

    def mexp_plain():
        prods = curve_torch.windowed_ladder(curve_torch.F2, g2_pt, g2_bits)
        return bls381_cuda.halving_sum(curve_torch.F2,
                                       tuple(c[None] for c in prods))
    g2_err = max(_max_err(bls381_cuda.g2_ladder(g2_pt, g2_bits),
                          curve_torch.windowed_ladder(curve_torch.F2, g2_pt,
                                                      g2_bits)),
                 _max_err(mexp(), mexp_plain()))
    max_err["bls381_g2"] = g2_err
    check(g2_err == 0, f"the G2 ladder or g2_multi_exp at the block's shape "
          f"!= plain ({g2_err})")
    mexp_ms = graph_ms(mexp, 3)
    mexp_plain_ms = cuda_ms(mexp_plain, 1, warmup=0)
    # the ladders' live rows, then the sum's adds of the 14 live products
    g2_scal = coeffs + [0] * (k - n_sets)
    g2_products, g2_chain = windowed_products(64, G2_DOUBLE_PRODUCTS,
                                              G2_ADD_PRODUCTS)
    g2_live = _live_rows(g2_pt, g2_scal)
    times["bls381_g2"] = (
        graph_ms(lambda: bls381_cuda.g2_ladder(g2_pt, g2_bits), 3),
        cuda_ms(lambda: curve_torch.windowed_ladder(
            curve_torch.F2, g2_pt, g2_bits), 1, warmup=0),
        *op_bound(g2_live * g2_products, k * (72 * 4 * 2 + 64), n_sms,
                  max_mhz))
    mexp_bound, mexp_by = op_bound(
        g2_live * g2_products + (n_sets - 1) * G2_ADD_PRODUCTS,
        k * (72 * 4 + 64) + 72 * 4, n_sms, max_mhz)
    times["bls381_pairing"] = pairing_launches(
        {k + 1: bls381_cuda.fold_lanes(*inputs, consts),
         K4_SIZES[1][1] + 1: bls381_cuda.fold_lanes(
             *fold_in[K4_SIZES[1][1]], consts)}, k + 1, max_err, n_sms,
        max_mhz)
    # K1 at its paths' shapes: the block's committee sums, the fold's
    # signature sum, the blob verify's lincomb sum
    for label, (g2, live, width) in {
            f"G1 {K1_BLOCK[0]} x {K1_BLOCK[1]}, the block's committee sums": (
                False, K1_BLOCK[0] * K1_BLOCK[1], K1_BLOCK[1]),
            f"G2 1 x {K1_FOLD[1]}, the fold's signature sum": (
                True, K1_FOLD[0], K1_FOLD[1]),
            f"G1 1 x {K1_BLOB[1]}, the blob verify's lincomb sum": (
                False, K1_BLOB[0], K1_BLOB[1])}.items():
        pt = segs[label.split(",")[0]]
        F = curve_torch.F2 if g2 else curve_torch.F1
        n_seg = pt[0].shape[0]
        add = G2_ADD_PRODUCTS if g2 else G1_ADD_PRODUCTS
        ms = graph_ms(lambda: bls381_cuda.segment_sum(pt), 10)
        # the kernel alone on packed words, each launch on a fresh copy (it
        # sums in place), less the copy
        words = bls381_cuda._words(torch.stack(pt, dim=2))
        buf = words.clone()
        out = torch.empty((n_seg,) + tuple(words.shape[2:]),
                          dtype=words.dtype, device=CARD)
        k1 = cuda_build.build().segment_sum
        copy_ms = graph_ms(lambda: buf.copy_(words), 10)
        alone_ms = graph_ms(lambda: (buf.copy_(words),
                                     k1(g2, buf, width, out, n_seg)),
                            10) - copy_ms
        plain_ms = cuda_ms(lambda: _plain_halving(F, pt), 1)
        bound_ms, bound_by = op_bound(
            (live - n_seg) * add,
            (n_seg * width + n_seg) * (72 if g2 else 36) * 4, n_sms,
            max_mhz)
        chain, passes = k1_levels(width, g2)
        if not g2 and n_seg == K1_BLOCK[0]:
            times["bls381_segment_sum"] = (ms, plain_ms, bound_ms, bound_by)
        print(f"bls381_segment_sum {label}: {ms:.6f} ms from a CUDA graph "
              f"through the wrapper (its limb and word conversions with "
              f"it), {alone_ms:.6f} ms the kernel alone; plain torch "
              f"{plain_ms:.6f} ms, bound {bound_ms:.6f} ms by {bound_by} "
              f"({live - n_seg} live adds); dependent chain {chain} Fq "
              f"products over {passes} product level passes (a thread an "
              f"add: {int(math.log2(width)) * add}); "
              f"{alone_ms * 1e3 / passes:.3f} us a pass alone", flush=True)
    for name, (ms, plain_ms, bound_ms, bound_by) in times.items():
        print(f"{name} at the block's shape: {ms:.6f} ms from a CUDA "
              f"graph, plain torch {plain_ms:.6f} ms, bound {bound_ms:.6f} "
              f"ms by {bound_by}; no PyTorch call computes it, so no "
              f"library time")
    print(f"bls381_fold's longest leg alone, the cofactor kernel on the "
          f"flush's {k} hash points: {leg_ms:.6f} ms from a CUDA graph")
    print(f"the block's one-launch fold (14 sets, 16 lanes): the fold's "
          f"lanes, sum and tail, the Miller loops and their product "
          f"{chain_ms:.6f} ms, with the final exponentiation "
          f"{verdict_ms:.6f} ms, from a CUDA graph; g2_multi_exp of 14 "
          f"signatures padded to 16 (G2 ladder of 64 bits, then K1, == "
          f"plain bit for bit) {mexp_ms:.6f} ms, plain torch "
          f"{mexp_plain_ms:.6f} ms, bound {mexp_bound:.6f} ms by {mexp_by}")
    print(f"dependent chains (csrc/bls381_ladder.cuh): K2 {k2_chain} Fq "
          f"products a 64-bit row, {blob_chain} a split 256-bit row; the G2 "
          f"ladder {g2_chain} a 64-bit row; a dependent product "
          f"{times['bls381_g1_ladder'][0] * 1e6 / k2_chain:.1f} ns in K2 at "
          f"{K2_TIMED} rows, {blob[1] * 1e6 / blob_chain:.1f} ns at the "
          f"blob verify's rows, "
          f"{times['bls381_g2'][0] * 1e6 / g2_chain:.1f} ns in the G2 ladder")
    print(f"bls381_g1_ladder at the blob verify's shape ({K2_BLOB[0]} "
          f"points padded to {K2_BLOB[1]}, split 256-bit rows): {blob[0]:.6f} "
          f"ms from a CUDA graph through the wrapper, {blob[1]:.6f} ms the "
          f"kernel alone, plain torch {blob[2]:.6f} ms, bound {blob[3]:.6f} "
          f"ms by {blob[4]}")
    return max_err, times


def pairing_launches(legs, block_legs, max_err, n_sms, max_mhz):
    """The pairing kernel's launches alone, each through its wrapper
    (bls381_cuda.miller, product_final) from a CUDA graph, beside the plain
    version's time and the operation bound, and held against the plain
    version bit for bit: launch 1 over each set of fold legs in `legs`
    ({n: (xp, yp, xq, yq, skip)}), launch 2 over one job of their n Miller
    values without the final exponentiation, and over one job of the
    block's partial product with it.  Returns (ms, plain ms, bound ms,
    bound_by) of the block's three launches (block_legs legs): the flush's
    chain after its lanes."""
    final_products = FINAL_EXP_PRODUCTS - (FQ_INV - GCD_FQ_INV)
    rows = {}

    def row(label, key, fn, plain, products, n_bytes):
        ms = graph_ms(fn, 3)
        got = fn()
        plain_ms, want = timed_once(plain)
        # the Fq12 values (product_final's product; its verdict below)
        err = _max_err(*(out[0] if isinstance(out, tuple) else out
                         for out in (got, want)))
        bound_ms, bound_by = op_bound(products, n_bytes, n_sms, max_mhz)
        max_err["bls381_pairing"] = max(max_err["bls381_pairing"], err)
        check(err == 0, f"bls381_pairing {label} != plain ({err})")
        rows[key] = (ms, plain_ms, bound_ms, bound_by)
        print(f"bls381_pairing {label}: == plain bit for bit; {ms:.6f} ms "
              f"from a CUDA graph, plain torch {plain_ms:.6f} ms, bound "
              f"{bound_ms:.6f} ms by {bound_by} ({products} products)",
              flush=True)
        return got, want

    for n, pairs in legs.items():
        live = int((~pairs[4]).sum())
        f, _ = row(f"launch 1 (Miller loops) at {n} legs, {live} live",
                   ("miller", n), lambda: bls381_cuda.miller(*pairs),
                   lambda: pairing_torch.miller_loop(*pairs),
                   live * MILLER_PRODUCTS, n * ((24 + 48 + 144) * 4 + 1))
        (prod, _), _ = row(
            f"launch 2 (product) over one job of {n}", ("product", n),
            lambda: bls381_cuda.product_final(f[None], final=False),
            lambda: pairing_torch.product_final(f[None], final=False),
            54 * (n - 1), (n + 1) * 144 * 4)
        if n != block_legs:
            continue
        (_, ok), (_, want_ok) = row(
            "launch 2 (final exponentiation) over one job of 1, verdict "
            "True", ("final", 1),
            lambda: bls381_cuda.product_final(prod[None], final=True),
            lambda: pairing_torch.product_final(prod[None], final=True),
            final_products, 2 * 144 * 4 + 1)
        check(ok.tolist() == want_ok.tolist() == [True],
              f"bls381_pairing's verdict on the block's flush: "
              f"{ok.tolist()}, plain {want_ok.tolist()}")
    chain = [rows[("miller", block_legs)], rows[("product", block_legs)],
             rows[("final", 1)]]
    return (sum(r[0] for r in chain), sum(r[1] for r in chain),
            sum(r[2] for r in chain), "operations")


def _flush_counts():
    return {w.__name__: w.launches
            for ws in bls381_cuda.WRAPPERS.values() for w in ws}


def _plain_counts():
    return [w.plain_calls for ws in bls381_cuda.WRAPPERS.values()
            for w in ws]


FLUSH_VARIANTS = ("one-launch fold", "staged fold", "unfolded")


def run_flush(sets, variant):
    """verify_sets over `sets` in one of FLUSH_VARIANTS, with fresh
    aggregate sums (decoded pubkeys stay cached) and the counts set to 0
    just before: (verdicts, seconds, metrics snapshot, launches)."""
    sig_fold.FOLD_MODE = "off" if variant == "unfolded" else "on"
    pairing_torch.PAIRING_MODE = ("staged" if variant == "staged fold"
                                  else "fused")
    try:
        sig_cache.AGGREGATES.clear()
        METRICS.reset()
        _reset_bls_counts()
        t0 = time.perf_counter()
        verdicts = sig_scheduler.verify_sets(sets)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return verdicts, seconds, METRICS.snapshot(), _flush_counts()
    finally:
        sig_fold.reset_mode()
        pairing_torch.reset_mode()


@phase("flush")
def flush_phase():
    """Seeded flushes through `scheduler.verify_sets` on the device
    backend, at 16 sets (the one at index 8 bad) and 256 (all valid), in
    the three variants: the one-launch fold, the staged fold (PAIRING_MODE
    "staged": K2, the G2 fold, the pairing check) and the unfolded flush
    (FOLD_VERIFY off: K2 at 2N, the pairing check).  The verdicts of the
    three must equal each other, the construction and the native oracle
    (every set at 16, ORACLE_SAMPLE seeded sets and the bad one at 256);
    the legs must be N + 1 folded and 2N unfolded; the bad set must be
    isolated alone.  Returns the launches of the staged and unfolded runs
    by wrapper (K2, the G2 ladder of the staged multi-exponentiation, the
    four-warp pairing check)."""
    bls.use_backend("cuda")
    bls.bls_active = True
    plain = _plain_counts()
    scalar_launches = {"g1_ladder": 0, "g2_ladder": 0, "pairing_check": 0}
    for n in FLUSH_SIZES:
        bad = (FLUSH_BAD,) if n == 16 else ()
        sets, _aggs, _sigs, _coeffs = flush_case(n, bad)
        expected = [i not in bad for i in range(n)]
        sample = range(n) if n <= ORACLE_SAMPLE else sorted(
            {*np.random.default_rng([SEED, 14, n]).choice(
                n, ORACLE_SAMPLE, replace=False).tolist(), *bad})
        t0 = time.perf_counter()
        oracle = native_verdicts(sets, sample)
        check(all(oracle[i] == expected[i] for i in sample),
              f"flush {n}: the native oracle disagrees with the "
              f"construction: {oracle}")
        print(f"flush {n}: native oracle on {len(sample)} sets == the "
              f"construction ({time.perf_counter() - t0:.6f} s)", flush=True)
        for variant in FLUSH_VARIANTS:
            verdicts, seconds, snap, launches = run_flush(sets, variant)
            legs = snap["miller_loops_per_flush"]["total"]
            want_legs = 2 * n if variant == "unfolded" else n + 1
            check(verdicts == expected,
                  f"flush {n} {variant}: verdicts differ at "
                  f"{[i for i, v in enumerate(verdicts) if v != expected[i]]}")
            check(legs == want_legs,
                  f"flush {n} {variant}: {legs} legs, expected {want_legs}")
            if variant == "one-launch fold":
                check(launches["fold_lanes"] == bls381_cuda.FOLD_LAUNCHES
                      and launches["clear_cofactor_g2"] >= 1
                      and launches["segment_sum"] >= 2
                      and launches["g1_ladder"] == 0,
                      f"flush {n} {variant}: launches {launches}")
            else:
                check(launches["fold_lanes"] == 0
                      and launches["g1_ladder"] >= 1
                      and launches["pairing_check"] >= 1,
                      f"flush {n} {variant}: launches {launches}")
                for name in scalar_launches:
                    scalar_launches[name] += launches[name]
            print(f"flush {n} {variant}: verdicts == construction == "
                  f"oracle ({'set 8 isolated, ' if bad else ''}"
                  f"{snap.get('bisect_dispatches', 0)} bisection probes), "
                  f"{legs} Miller legs, {seconds:.6f} s; launches "
                  f"{launches}", flush=True)
    check(_plain_counts() == plain, "flush: a wrapper took its plain version")
    return scalar_launches


# ---------------------------------------------------------------------------
# slice 7: the KZG blob path and the Pippenger G1 MSM
# ---------------------------------------------------------------------------

KZG_BLOBS = 6                   # bench.py N_BLOBS, deneb MAX_BLOBS_PER_BLOCK
KZG_BLOB_SEED = 7               # bench.py bench_kzg's np.random.default_rng(7)
CEREMONY_CONSTANT = 987654321   # tests/test_kzg.py's constant blob
# the JAX package's host KZG on the ceremony setup over the six blobs
# (scripts/torch_kzg_reference.py): commitments, blob proofs, and the
# constant blob's commitment
KZG_COMMITMENTS = (
    "838232ef90ebd2dbba14aa42a0a04fd325338da2643d9403"
    "29eeb49344efb2c4e3e0dccece4cab4003ea66375e1961c3",
    "b7773765e868a7e9fc54956a9c422ec212bcaa1b3b89d6a6"
    "4fc5df09f488eb322e459bad06c5989582439546a76a4626",
    "84d8bd9550b2f07f99362fbca0c50f21f6f2c8113b8c94b7"
    "e4b2e3be231ada0a437b5a6d27070c4eceaca05a6658893e",
    "b4208e18648ebed2bd8a926fa5ffda14ed0626ca5ae89f1b"
    "dfeec02661e6e0b19a6e3c0d3bdf59e00c605449c3114d02",
    "a627d4a65e4eff1d09bd63205b9981d95f14e4ddbf76a776"
    "c3d04386a0cf417cc9211c5c2584b6c9f8fe6337d1485900",
    "b5aa5b1ab2f0f8d77e4b4f950b078af8d1f42b95e6897df5"
    "058ab95b236354323b3de485d089dfe551e7d98fee74065c",
)
KZG_PROOFS = (
    "aeb369dbaeff67b898a785ee2bd520b20e7105c90845ab6f"
    "8feb5bb8271f41112a0fdfdacf34e2564127db5df2d5fa36",
    "ae5a3e85ab810e2072dda597708ea4d932d1c935183aab89"
    "b88b8ef344881ebd3d5e924d1a8235bc314b3e2b8c17915f",
    "afec525bbb7b928a6f41bed925cb537f11b9a4a8453f417c"
    "a16ca06e12d33174c9c7c2f2678319f75ddc6d02be7b3471",
    "9205fb4cefe6451874602a8efc2f0191b567d13a0186a5df"
    "ded0c862fdfaf078d2c6325a594029981f8fb214565ae2d6",
    "8564b98533d90b8bfe34dc3f945a1242f0b869aa39eb5e78"
    "e0e38038fcd7b2b965e87e58340423d444778bd2b6136628",
    "981781039deabee7226b4ab8c8afb95df52d1a32fc7cb822"
    "36daed110cd3bdc2d22d9c5aeba1f105e80b4c74e267e9a6",
)
KZG_CONSTANT_COMMITMENT = (
    "8e561be3daa71004f1079f6e5de35a852cc5a167305fb100"
    "4a447642981306118df2244de29566320a8fb4b727021f89")
MSM_SIZES = (256, 300, 1024, 4096)  # 256: the edge rows; 300: padded
MSM_TIMED = 4096                # a blob's commitment or proof
_KZG = {}


def kzg_engine():
    """The port's KZG engine on the ceremony setup (crypto/kzg.get_kzg),
    its setup decompressed once; the seconds of the decompression."""
    from consensus_specs_tpu_torch.crypto import kzg as kzg_mod
    if not _KZG:
        t0 = time.perf_counter()
        kz = kzg_mod.get_kzg(4096)
        kz.g1_lagrange_brp()
        kz.g2_monomial()
        _KZG.update(engine=kz, setup_s=time.perf_counter() - t0)
    return _KZG["engine"]


def kzg_blobs(width):
    """bench.py bench_kzg's blobs: 31 seeded low bytes a field element."""
    rng = np.random.default_rng(KZG_BLOB_SEED)
    out = []
    for _ in range(KZG_BLOBS):
        elems = rng.integers(0, 256, size=(width, 32), dtype=np.uint8)
        elems[:, 0] = 0
        out.append(elems.tobytes())
    return out


def _msm_case(n, equal=False):
    """n points of the ceremony's Lagrange basis (the blob path's bases)
    and seeded scalars below r; at 256 the reference test's edge rows
    (scalars 0, 1, r - 1, the lowest window alone, the highest window
    alone, an infinity point); with `equal` every scalar the same seeded
    one (a constant blob's commitment: each window's points in one
    bucket)."""
    pts = list(kzg_engine().g1_lagrange_brp()[:n])
    raw = np.random.default_rng([SEED, 21, n]).integers(
        0, 256, size=(n, 32), dtype=np.uint8)
    scalars = [int.from_bytes(row.tobytes(), "big") % R for row in raw]
    if equal:
        scalars = [scalars[0]] * n
    elif n == 256:
        scalars[:5] = [0, 1, R - 1, 255, 1 << 248]
        pts[5] = cv.g1_infinity()
    return pts, scalars


def _g1_affine(point):
    """A Jacobian G1 point (X, Y, Z), each [32], on the card -> its affine
    limbs [2, 32] (zeros at infinity) and compressed bytes."""
    X, Y, Z = (c[None] for c in point)
    zero = torch.zeros_like(X[0])
    x, y, _inf = pairing_torch._g1_jacobian_to_affine((X, Y, Z), zero, zero)
    return (torch.cat([x, y]),
            cv.g1_to_bytes(curve_torch.g1_unpack(tuple(
                c.cpu() for c in (X, Y, Z)))[0]))


def pippenger_work(digits, n_chunk):
    """What the Pippenger kernel computes over `digits` (numpy [32, n]),
    in point adds and doublings: (nonzero digits, work items, non-empty
    buckets, adds, doublings).  A work item's first point is a load; its
    other points are adds (mixed where Z = 1), a bucket's items a tree of
    items - 1 adds, each bit tree 127 adds, each window's combination 7
    doublings and 7 adds, Horner 31 x 8 doublings and 31 adds."""
    counts = np.stack([np.bincount(row, minlength=256)[1:]
                       for row in digits.astype(np.int64)])
    nonzero = int(counts.sum())
    items = int((-(-counts // n_chunk)).sum())
    buckets = int((counts > 0).sum())
    n_win = digits.shape[0]
    adds = (nonzero - items) + (items - buckets) + n_win * 8 * 127 \
        + n_win * 7 + (n_win - 1)
    doublings = n_win * 7 + (n_win - 1) * 8
    return nonzero, items, buckets, adds, doublings


@phase("msm kernel")
def msm_kernel_phase(n_sms, max_mhz):
    """The Pippenger kernel (csrc/bls381_pippenger.cu, five launches)
    against its plain torch version (ops/msm.py `_pippenger_g1`) and the
    host oracle crypto/curve.msm on the card: the result's affine words
    and compressed bytes (its Jacobian words follow its own order of
    additions) at 256 (edge rows: scalars 0, 1, r - 1, single windows, an
    infinity point), 300, 1,024 and 4,096 points of the ceremony basis,
    and at 4,096 points with every scalar equal (the kernel on the n
    points, the plain version on them padded with infinity to a power of
    two); at each size the kernel and the lanes engine on the padded
    points (K2 at 256 bits, then K1) from a CUDA graph, to weigh `g1_multi_exp`'s size
    threshold.  Then at 4,096 points: each of the kernel's launches and
    the plain version, beside the operation bound."""
    from consensus_specs_tpu_torch.ops import msm
    max_err = 0
    t0 = time.perf_counter()
    kzg_engine()
    for n, equal in [(n, False) for n in MSM_SIZES] + [(MSM_TIMED, True)]:
        pts, scalars = _msm_case(n, equal)
        pt, digits = msm._pippenger_inputs(pts, scalars, CARD)
        # the plain version and the lanes engine take the points padded
        ppt, pdigits = msm._pippenger_inputs(pts, scalars, CARD,
                                             threads=msm._THREADS)
        got, got_bytes = _g1_affine(bls381_cuda.pippenger_g1(pt, digits))
        want, want_bytes = _g1_affine(msm._pippenger_g1(*ppt, pdigits))
        oracle = cv.g1_to_bytes(cv.msm(pts, scalars))
        err = _max_err(got, want)
        max_err = max(max_err, err)
        label = f"{n} points{' (equal scalars)' if equal else ''}"
        check(err == 0 and got_bytes == want_bytes,
              f"pippenger_g1 at {label}: affine != plain ({err})")
        check(got_bytes == oracle,
              f"pippenger_g1 at {label} != crypto/curve.msm")
        m = ppt[0].shape[0]
        kernel_ms = graph_ms(lambda: bls381_cuda.pippenger_g1(pt, digits), 3)
        lanes = ""
        if not equal:
            bits = curve_torch.glv_bits(scalars + [0] * (m - n), CARD)
            lanes_ms = graph_ms(lambda: bls381_cuda.segment_sum(tuple(
                c[None] for c in bls381_cuda.g1_ladder(ppt, bits))), 3)
            lanes = f", lanes engine {lanes_ms:.6f} ms"
        print(f"bls381_pippenger: {label} == plain (affine words, "
              f"compressed bytes; the plain version and the lanes engine on "
              f"the points padded to {m}) == crypto/curve.msm, kernel "
              f"{kernel_ms:.6f} ms{lanes} from a CUDA graph "
              f"({time.perf_counter() - t0:.6f} s into the phase)",
              flush=True)

    n = MSM_TIMED
    pts, scalars = _msm_case(n)
    pt, digits = msm._pippenger_inputs(pts, scalars, CARD)
    kernel_ms = graph_ms(lambda: bls381_cuda.pippenger_g1(pt, digits), 3)
    kernels = cuda_build.build()
    words = fq.to_words(torch.stack(pt, dim=1)).contiguous()
    d8 = digits.to(torch.uint8).contiguous()
    scratch = bls381_cuda.pippenger_scratch(n, CARD)
    kernels.pippenger(words, d8, n, *scratch.values(), 0)
    stage_ms = [graph_ms(lambda: kernels.pippenger(
        words, d8, n, *scratch.values(), stage), 3) for stage in range(1, 6)]
    bits = curve_torch.glv_bits(scalars, CARD)

    def lanes():
        return bls381_cuda.segment_sum(tuple(
            c[None] for c in bls381_cuda.g1_ladder(pt, bits)))
    lanes_pt = curve_torch.g1_unpack(tuple(c.cpu() for c in lanes()))[0]
    _pip, pip_bytes = _g1_affine(bls381_cuda.pippenger_g1(pt, digits))
    check(cv.g1_to_bytes(lanes_pt) == pip_bytes,
          f"the lanes engine and the Pippenger kernel differ at {n} points")
    lanes_ms = graph_ms(lanes, 3)
    plain_ms = cuda_ms(lambda: msm._pippenger_g1(*pt, digits), 1, warmup=0)
    # what the function needs over this run's digits: each non-empty
    # bucket's points less one as adds (its first point is a load; an add
    # is mixed where its point is affine, Z = 1 in the packed input, as
    # every ceremony basis point is, and a projective point takes the load
    # where there is one), 2 * 254 general adds a window for the running
    # sums that weigh the buckets, Horner's 248 doublings (the first 8
    # double infinity) and 31 adds
    d_np = digits.cpu().numpy()
    nonzero, items, buckets, adds, doublings = pippenger_work(
        d_np, bls381_cuda.PIPPENGER_CHUNK)
    affine = (pt[2] == torch.from_numpy(fq.ONE_MONT_LIMBS).to(
        pt[2])).all(dim=-1).cpu().numpy().astype(np.float64)
    mixed = 0
    for row in d_np.astype(np.int64):
        in_bucket = np.bincount(row, minlength=256)[1:]
        affine_in = np.bincount(row, weights=affine, minlength=256)[1:]
        mixed += int(np.minimum(affine_in,
                                np.maximum(in_bucket - 1, 0)).sum())
    bucket_adds = nonzero - buckets
    needed = mixed * G1_MIXED_ADD_PRODUCTS \
        + (bucket_adds - mixed + 32 * 2 * 254 + 31) * G1_ADD_PRODUCTS \
        + 248 * G1_DOUBLE_PRODUCTS
    # the kernel's: its chunk adds mixed (every basis point has Z = 1),
    # the trees' and Horner's general
    computed = (nonzero - items) * G1_MIXED_ADD_PRODUCTS \
        + (adds - (nonzero - items)) * G1_ADD_PRODUCTS \
        + doublings * G1_DOUBLE_PRODUCTS
    n_bytes = n * (36 * 4 + 32) + 36 * 4
    bound_ms, bound_by = op_bound(needed, n_bytes, n_sms, max_mhz)
    computed_ms, _ = op_bound(computed, n_bytes, n_sms, max_mhz)
    names = ("bucket", "sums", "tree", "bits", "Horner")
    print(f"bls381_pippenger at {n} points: {kernel_ms:.6f} ms from a CUDA "
          f"graph ({', '.join(f'{a} {b:.6f} ms' for a, b in zip(names, stage_ms))}"
          f"), plain torch {plain_ms:.6f} ms; the lanes engine on the same "
          f"points (K2 at 256 bits, then K1; == the kernel's point) "
          f"{lanes_ms:.6f} ms; bound {bound_ms:.6f} ms by {bound_by} "
          f"({needed} Fq products: {bucket_adds} bucket adds, {mixed} of "
          f"them mixed, for {nonzero} nonzero digits in {buckets} non-empty "
          f"buckets, {32 * 2 * 254} running-sum adds, Horner's 248 "
          f"doublings and 31 adds); the kernel computes "
          f"{computed} ({computed_ms:.6f} ms at the same rate; {items} work "
          f"items of at most {bls381_cuda.PIPPENGER_CHUNK} points over "
          f"{buckets} non-empty buckets); no PyTorch call computes an MSM, "
          f"so no library time")
    times = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, lanes_ms=lanes_ms)
    return max_err, times


class KzgRecorder(HostClock):
    """Host clocks around the parts of the blob path: blob_to_polynomial,
    the barycentric evaluations, the proofs (evaluation, quotient and MSM
    together), the device MSMs with their host packing and digits, the
    subgroup checks and the host pairings, and the card's launches (the
    Pippenger kernel's three, the lanes engine's K2 and K1), each from its
    launch to a synchronize."""

    def __init__(self, kz):
        super().__init__()
        from consensus_specs_tpu_torch.crypto import pairing
        from consensus_specs_tpu_torch.ops import msm
        self._wrap("blob_to_polynomial", kz, "blob_to_polynomial",
                   instance=True)
        self._wrap("barycentric evaluation", kz,
                   "evaluate_polynomial_in_evaluation_form", instance=True)
        self._wrap("proof: evaluation, quotient and MSM", kz,
                   "compute_kzg_proof_impl", instance=True)
        self._wrap("device MSM with its host packing", kz, "g1_lincomb",
                   instance=True)
        self._wrap("subgroup checks", kz, "validate_kzg_g1", instance=True)
        self._wrap("digits (_digits_np)", msm, "_digits_np")
        self._wrap("point packing (g1_pack)", curve_torch, "g1_pack")
        self._wrap("host pairings", pairing, "pairing_check")
        self._wrap("batch lincombs", sig_fold, "fold_kzg_lincombs")
        launchers = cuda_build.build()
        self._wrap("card: Pippenger", launchers, "pippenger", sync=True)
        for name in ("g1_ladder", "segment_sum"):
            self._wrap("card: lanes engine", launchers, name, sync=True)

    def report(self, step):
        parts = ", ".join(f"{label} {sec:.6f} s ({self.calls[label]})"
                          for label, sec in self.seconds.items())
        print(f"kzg {step}: {parts}", flush=True)


def _kzg_step(kz, step, fn):
    """fn() with the blob path's host clocks on: (result, seconds,
    recorder)."""
    rec = KzgRecorder(kz)
    try:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        rec.close()
    rec.report(step)
    return out, seconds, rec


@phase("kzg")
def kzg_phase():
    """The deneb blob path on the card through the port's KZG engine
    (crypto/kzg.py, its device MSM installed by default): the ceremony
    setup, bench.py's six blobs of 4,096 field elements, their
    commitments and blob proofs (12 MSMs of 4,096 points on the Pippenger
    kernel) and `verify_blob_kzg_proof_batch` (its three 6-point lincombs
    on the lanes engine, one 2-leg host pairing), with the counts set to 0
    just before and read just after.  The commitments and proofs must
    equal the JAX package's (KZG_COMMITMENTS, KZG_PROOFS), the verdict must
    be True; a copy with two proofs swapped must give False with the
    attribution counted; commit(constant c) must equal c G1 and the JAX
    package's.  Prints each part's host seconds.  Returns the launches by
    wrapper."""
    from consensus_specs_tpu_torch.crypto import kzg as kzg_mod
    check(kzg_mod._device_msm is kzg_mod._default_device_msm
          and kzg_mod._device_msm_threshold == 128,
          f"kzg: device MSM {kzg_mod._device_msm} at "
          f"{kzg_mod._device_msm_threshold}, not ops/msm.g1_multi_exp at 128")
    kz = kzg_engine()
    print(f"kzg: setup decompression (4,096 G1 Lagrange points, 65 G2 "
          f"monomial points) {_KZG['setup_s']:.6f} s", flush=True)
    blobs = kzg_blobs(kz.width)
    plain = _plain_counts()
    METRICS.reset()
    _reset_bls_counts()
    commitments, commit_s, _rec = _kzg_step(
        kz, "commitments", lambda: [kz.blob_to_kzg_commitment(b)
                                    for b in blobs])
    proofs, proof_s, rec = _kzg_step(
        kz, "proofs", lambda: [kz.compute_blob_kzg_proof(b, c)
                               for b, c in zip(blobs, commitments)])
    ok, verify_s, _rec = _kzg_step(
        kz, "batch verify", lambda: kz.verify_blob_kzg_proof_batch(
            blobs, commitments, proofs))
    launches = _flush_counts()
    snap = METRICS.snapshot()
    check(_plain_counts() == plain, "kzg: a wrapper took its plain version")
    sec = rec.seconds
    quotient_s = sec["proof: evaluation, quotient and MSM"] \
        - sec["barycentric evaluation"] \
        - sec["device MSM with its host packing"]
    print(f"kzg: {KZG_BLOBS} commitments {commit_s:.6f} s "
          f"({commit_s / KZG_BLOBS:.6f} s a blob), {KZG_BLOBS} blob proofs "
          f"{proof_s:.6f} s ({proof_s / KZG_BLOBS:.6f} s a blob; quotient "
          f"{quotient_s:.6f} s in all), batch verify {verify_s:.6f} s; "
          f"launches {launches}", flush=True)
    check([c.hex() for c in commitments] == list(KZG_COMMITMENTS),
          f"kzg: commitments {[c.hex()[:16] for c in commitments]} != the "
          f"JAX package's")
    check([p.hex() for p in proofs] == list(KZG_PROOFS),
          f"kzg: proofs {[p.hex()[:16] for p in proofs]} != the JAX "
          f"package's")
    check(ok is True, f"kzg: batch verdict {ok} on valid proofs")
    legs = snap.get("kzg_pairing_legs", {})
    check(legs.get("count") == 1 and legs.get("total") == 2
          and snap.get("kzg_batch_attributions", 0) == 0
          and snap.get("fold_dispatches") == 1,
          f"kzg: counters {snap}")
    per_msm = bls381_cuda.PIPPENGER_LAUNCHES
    check(launches["pippenger_g1"] == 2 * KZG_BLOBS * per_msm
          and launches["g1_ladder"] == 3 and launches["segment_sum"] == 3,
          f"kzg: launches {launches}, expected {2 * KZG_BLOBS} Pippenger "
          f"MSMs of {per_msm} launches and three lincombs on K2 and K1")
    print(f"kzg: {KZG_BLOBS} commitments and {KZG_BLOBS} proofs == the JAX "
          f"package's, batch verdict True (one 2-leg pairing); "
          f"{launches['pippenger_g1']} Pippenger launches "
          f"({2 * KZG_BLOBS} MSMs), {launches['g1_ladder']} K2 and "
          f"{launches['segment_sum']} K1 launches", flush=True)

    METRICS.reset()
    swapped = [proofs[1], proofs[0], *proofs[2:]]
    bad, bad_s, _rec = _kzg_step(
        kz, "batch verify, two proofs swapped",
        lambda: kz.verify_blob_kzg_proof_batch(blobs, commitments, swapped))
    snap = METRICS.snapshot()
    check(bad is False and snap.get("kzg_batch_attributions") == 1,
          f"kzg: swapped proofs gave {bad}, counters {snap}")
    print(f"kzg: two proofs swapped: verdict False, the batch re-checked "
          f"blob by blob ({snap['kzg_pairing_legs']['total']} legs in all), "
          f"{bad_s:.6f} s", flush=True)

    constant = kz.blob_to_kzg_commitment(
        kzg_mod.bls_field_to_bytes(CEREMONY_CONSTANT) * kz.width)
    check(constant == cv.g1_to_bytes(cv.g1_generator() * CEREMONY_CONSTANT)
          and constant.hex() == KZG_CONSTANT_COMMITMENT,
          f"kzg: commit(constant) {constant.hex()} != c G1 or the JAX "
          f"package's")
    print(f"kzg: commit(constant {CEREMONY_CONSTANT}) == c G1 == the JAX "
          f"package's", flush=True)
    return launches


PHASES = ("kernel", "main path", "incremental", "gather kernel", "epoch",
          "epoch kernel", "bls kernels", "bls", "flush kernels", "flush",
          "block", "msm kernel", "kzg")


def main(argv=None):
    """Every phase, then the kernels' line, the card and the ok line.
    `--only name,name` (names of PHASES) runs those phases alone after the
    device and build phases, for iterating on one path, and prints no
    result lines."""
    import sys
    argv = sys.argv[1:] if argv is None else argv
    only = None
    if argv[:1] == ["--only"] and len(argv) == 2:
        only = argv[1].split(",")
        unknown = [name for name in only if name not in PHASES]
        check(not unknown, f"unknown phases {unknown}; known: {PHASES}")
    elif argv:
        check(False, f"usage: chip_smoke.py [--only phase,phase]; got {argv}")
    card, n_sms, max_mhz = device_phase()
    build_phase()
    if only is not None:
        runs = {
            "kernel": lambda: kernel_phase(n_sms, max_mhz),
            "main path": main_path_phase, "incremental": incremental_phase,
            "epoch": epoch_phase,
            "epoch kernel": lambda: epoch_kernel_phase(n_sms, max_mhz),
            "bls kernels": lambda: bls_kernels_phase(n_sms, max_mhz),
            "bls": bls_phase,
            "flush kernels": lambda: flush_kernels_phase(n_sms, max_mhz),
            "flush": flush_phase, "block": block_phase,
            "msm kernel": lambda: msm_kernel_phase(n_sms, max_mhz),
            "kzg": kzg_phase}
        for name in only:
            check(name in runs, f"phase {name} cannot run alone")
            runs[name]()
        return
    max_err, times = kernel_phase(n_sms, max_mhz)
    launches = main_path_phase()
    gather_launches, largest = incremental_phase()
    gather_err, g = gather_kernel_phase(n_sms, max_mhz, largest)
    epoch_launches = epoch_phase()
    epoch_err, e = epoch_kernel_phase(n_sms, max_mhz)
    bls_err, bls_times = bls_kernels_phase(n_sms, max_mhz)
    bls_phase()
    flush_err, flush_times = flush_kernels_phase(n_sms, max_mhz)
    flush_launches = flush_phase()
    bls_launches, sig_launches = block_phase()
    msm_err, msm_times = msm_kernel_phase(n_sms, max_mhz)
    kzg_launches = kzg_phase()
    t = times[MAIN_PATH_PAIRS]
    csrc = "consensus_specs_tpu_torch/ops/csrc/"
    bls_rows = [dict(
        name=name, route="cuda", source=csrc + source, replaces=replaces,
        launches=count, max_abs_err=err[name], ms=tm[name][0],
        plain_ms=tm[name][1], bound_ms=tm[name][2], bound_by=tm[name][3],
        library_ms=None)
        for name, source, replaces, count, err, tm in (
            ("bls381_cofactor", "bls381_cofactor.cu",
             "consensus_specs_tpu/ops/bls_tpu.py:38",
             bls_launches["bls381_cofactor"], bls_err, bls_times),
            ("bls381_check", "bls381_check.cu",
             "consensus_specs_tpu/ops/pairing_jax.py:706",
             bls_launches["bls381_check"], bls_err, bls_times),
            ("bls381_pairing", "bls381_pairing.cuh",
             "consensus_specs_tpu/ops/pairing_jax.py:393",
             sig_launches["bls381_pairing"],
             {"bls381_pairing": max(bls_err["bls381_pairing"],
                                    flush_err["bls381_pairing"])},
             flush_times),
            ("bls381_g2", "bls381_g2.cu",
             "consensus_specs_tpu/ops/curve_jax.py:175",
             flush_launches["g2_ladder"],
             {"bls381_g2": max(bls_err["bls381_g2"],
                               flush_err["bls381_g2"])}, flush_times),
            ("bls381_field", "bls381_field.cu",
             "consensus_specs_tpu/ops/fq.py:265",
             bls_launches["bls381_field"], bls_err, bls_times),
            ("bls381_segment_sum", "bls381_segment.cuh",
             "consensus_specs_tpu/ops/g1_sweep.py:84",
             sig_launches["bls381_segment_sum"], flush_err, flush_times),
            ("bls381_g1_ladder", "bls381_msm.cu",
             "consensus_specs_tpu/ops/msm.py:271",
             flush_launches["g1_ladder"], flush_err, flush_times),
            ("bls381_fold", "bls381_fold.cu",
             "consensus_specs_tpu/ops/pairing_jax.py:568",
             sig_launches["bls381_fold"], flush_err, flush_times),
            ("bls381_pippenger", "bls381_pippenger.cu",
             "consensus_specs_tpu/ops/msm.py:139",
             kzg_launches["pippenger_g1"],
             {"bls381_pippenger": msm_err},
             {"bls381_pippenger": (msm_times["ms"], msm_times["plain_ms"],
                                   msm_times["bound_ms"],
                                   msm_times["bound_by"])}))]
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
        "bound_by": e["bound_by"], "library_ms": None}, *bls_rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
