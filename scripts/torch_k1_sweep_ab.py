#!/usr/bin/env python3
"""K1 (the segment sums) and the epoch sweep of two trees side by side on
the card.

    python3 scripts/torch_k1_sweep_ab.py [--parent DIR] [--other NAME=CSRC]
                                         [--time-only NAME=CSRC]

Builds this tree's sources of the two kernels (K1: the csrc file that holds
`bls381_segment_sum_launch`, bls381_check.cu since the four-warp design and
bls381_msm.cu before it; the sweep: epoch_sweep.cu), and with --parent the
same of another checkout (DIR its root), with each --other those of another
csrc directory and with each --time-only one whose outputs are not held
(scripts/torch_ab_harness.py: the options, builds, turns and timing it
shares with torch_ladder_ab.py).  Prints ptxas's registers, stack and
spills of the two kernels' entries and of every function that spills, and
each tree's sweep kernels' and K1's functions' SASS by pipe (chip_smoke.py
`sass_functions`).  Then, at the paths' shapes:

- K1 on G1 8 x 128 (the block's committee sums), on G2 one segment of 16
  with 14 live points (the block fold's signature sum) and on G1 one of 8
  with 6 (the blob verify's lincomb sum), each launch on a fresh copy of
  the points (the kernel sums in place), timed with its copy and the copy
  alone;
- the epoch sweep at 262,144 lanes (the epoch path's phase0 sweep, the same
  with a proposer a lane, altair) and phase0 at 2^20 lanes, on
  chip_smoke.py's seeded columns, the parent's parameter array filled by
  its own `enum Param` names;

every tree's outputs equal the plain versions (bls381_cuda.halving_sum,
epoch_sweep.plain_sweep) bit for bit, and each is timed by CUDA events from
a CUDA graph, the trees in turn and then in the reverse order (parent, this
tree, the variants, then back).  Prints the card's name and power limit, then a
line a tree, shape and turn.  Needs a CUDA card; exits non-zero without one
or on any difference.
"""
import ctypes
import os
import re
import sys

import numpy as np
import torch

import torch_ab_harness as ab
import chip_smoke  # its segments, sweep columns and SASS count
from consensus_specs_tpu_torch.ops import (
    bls381_cuda, curve_torch, epoch_sweep, epoch_sweep_cuda, fq)

P, I64 = ctypes.c_void_p, ctypes.c_int64
KERNEL_WORDS = ("segment_sum", "sums", "phase0", "altair", "lanes")


def k1_source(csrc):
    """The csrc file that holds K1's C entry."""
    for f in sorted(os.listdir(csrc)):
        if f.endswith(".cu") and "bls381_segment_sum_launch" in open(
                os.path.join(csrc, f)).read():
            return f
    sys.exit(f"no K1 source in {csrc}")


def param_names(csrc):
    """The sweep's parameter slots, lower case without P_, from the tree's
    `enum Param` (epoch_sweep.cuh, or epoch_sweep.cu before it)."""
    for f in ("epoch_sweep.cuh", "epoch_sweep.cu"):
        path = os.path.join(csrc, f)
        m = os.path.exists(path) and re.search(
            r"enum Param : int \{(.*?)\};", open(path).read(), re.S)
        if m:
            body = re.sub(r"//[^\n]*", "", m.group(1))
            slots = [x.strip() for x in body.split(",") if x.strip()]
            return [x[2:].lower() for x in slots[:-1]]
    sys.exit(f"no enum Param in {csrc}")


class Tree:
    """One tree's K1 and sweep launchers."""

    def __init__(self, name, csrc):
        self.name = name
        self.params = param_names(csrc)
        self.lib, self.objs, self.ptxas = ab.build(
            csrc, (k1_source(csrc), "epoch_sweep.cu"),
            os.path.join(ab.ROOT, "build", "k1_sweep_ab", name),
            KERNEL_WORDS)
        self.lib.bls381_segment_sum_launch.argtypes = [
            ctypes.c_int, P, I64, P, I64, P]
        self.lib.epoch_sweep_launch.argtypes = [P, P, P]
        for fn in (self.lib.bls381_segment_sum_launch,
                   self.lib.epoch_sweep_launch):
            fn.restype = ctypes.c_int

    def segment_sum(self, g2, buf, out):
        rc = self.lib.bls381_segment_sum_launch(
            int(g2), buf.data_ptr(), buf.shape[1], out.data_ptr(),
            buf.shape[0], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{self.name}: K1 launch failed, CUDA error "
                               f"{rc}")

    def sweep(self, params):
        launched = ctypes.c_int(0)
        rc = self.lib.epoch_sweep_launch(
            params.ctypes.data, ctypes.addressof(launched),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{self.name}: sweep launch failed, CUDA "
                               f"error {rc}")
        return launched.value


def k1_cases():
    """label: (g2, points [s, L, 3, (2,) 12] int32 words, plain sums)."""
    cases = {}
    for label, (group, lengths, width) in {
            "K1, G1 8 x 128 (the block's committee sums)": (
                "g1", [128] * 8, 128),
            "K1, G2 1 x 16, 14 live (the block fold's signature sum)": (
                "g2", [14], 16),
            "K1, G1 1 x 8, 6 live (the blob verify's lincomb sum)": (
                "g1", [6], 8)}.items():
        pt = chip_smoke._segments(group, lengths, width)
        F = curve_torch.F2 if group == "g2" else curve_torch.F1
        words = bls381_cuda._words(torch.stack(pt, dim=2))
        cases[label] = (group == "g2", words,
                        chip_smoke._plain_halving(F, pt))
    return cases


def sweep_cases():
    """label: (columns, scalars, statics, altair, the plain lanes)."""
    cases = {}
    rng = np.random.default_rng(chip_smoke.SEED + 4)
    for n in (chip_smoke.EPOCH_TIMED, 1 << 20):
        base = chip_smoke.sweep_columns(rng, n)
        for case in (("phase0", "phase0 a proposer a lane", "altair")
                     if n == chip_smoke.EPOCH_TIMED else ("phase0",)):
            cols, scalars, statics = chip_smoke.sweep_case(
                base, "altair" if case == "altair" else "phase0")
            if case == "phase0 a proposer a lane":
                cols = dict(cols, best_prop=torch.arange(
                    n, dtype=torch.int64, device="cuda"))
            want = epoch_sweep.plain_sweep(cols, scalars, statics)
            cases[f"sweep, {case}, {n} lanes"] = (
                cols, scalars, dict(statics), case == "altair", want)
    return cases


def main():
    args = ab.parser(__doc__.split("\n\n")[0]).parse_args()
    ab.card()
    trees, unheld = ab.trees(args, Tree)
    for name, tree in trees.items():
        for obj in tree.objs:
            for fn, c in chip_smoke.sass_functions(
                    ab.cuobjdump_sass(obj)).items():
                if "epoch_sweep" in obj or "seg" in fn:
                    print(f"  sass {name} {fn}: {chip_smoke.pipes_text(c)}",
                          flush=True)
    order = ab.turns(trees)
    for label, (g2, words, want) in k1_cases().items():
        bufs, outs = {}, {}
        for name, tree in trees.items():
            bufs[name] = words.clone()
            outs[name] = torch.empty((words.shape[0],) + words.shape[2:],
                                     dtype=words.dtype, device="cuda")
            tree.segment_sum(g2, bufs[name], outs[name])
            torch.cuda.synchronize()
            got = fq.from_words(outs[name]).unbind(1)
            if name not in unheld and any(
                    not torch.equal(a, b) for a, b in zip(got, want)):
                sys.exit(f"{name}, {label}: != halving_sum")
        print(f"{label}: == halving_sum bit for bit in "
              f"{', '.join(n for n in trees if n not in unheld)}",
              flush=True)
        copy_ms = ab.graph_ms(lambda: bufs[order[0]].copy_(words), 20)
        for turn, name in enumerate(order):
            tree, buf, out = trees[name], bufs[name], outs[name]

            def run(tree=tree, buf=buf, out=out):
                buf.copy_(words)
                tree.segment_sum(g2, buf, out)
            ms = ab.graph_ms(run, 10)
            print(f"{label}, {name} (turn {turn + 1}): {ms:.6f} ms from a "
                  f"CUDA graph with the points' copy, {ms - copy_ms:.6f} ms "
                  f"without it (the copy alone {copy_ms:.6f} ms)", flush=True)
    for label, (cols, scalars, statics, altair, want) in sweep_cases().items():
        n = cols["eff"].shape[0]
        params, launches = {}, {}
        keep = []                     # tensors the parameter arrays point at
        for name, tree in trees.items():
            _buf, out = epoch_sweep.lane_buffers(altair, n, "cuda")
            scratch = torch.empty(3 + n, dtype=torch.int64, device="cuda")
            new = epoch_sweep_cuda._params(cols, scalars, statics, out,
                                           scratch, n, altair)
            by_name = dict(zip(epoch_sweep_cuda.PARAMS, new))
            params[name] = np.array([by_name[p] for p in tree.params],
                                    dtype=np.int64)
            keep.append((out, scratch))
            launches[name] = tree.sweep(params[name])
            torch.cuda.synchronize()
            if name not in unheld and any(
                    not torch.equal(g, w) for g, w in zip(out, want)):
                sys.exit(f"{name}, {label}: != plain_sweep")
        print(f"{label}: == plain_sweep bit for bit in "
              f"{', '.join(f'{k} ({v} launches)' for k, v in launches.items() if k not in unheld)}",
              flush=True)
        for turn, name in enumerate(order):
            tree, p = trees[name], params[name]
            ms = ab.graph_ms(lambda: tree.sweep(p), 50)
            print(f"{label}, {name} (turn {turn + 1}): {ms:.6f} ms from a "
                  f"CUDA graph", flush=True)


if __name__ == "__main__":
    main()
