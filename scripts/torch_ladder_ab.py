#!/usr/bin/env python3
"""The scalar ladders of two trees side by side on the card: K2 (the G1
ladder, ops/csrc/bls381_msm.cu) and the G2 ladder (ops/csrc/bls381_g2.cu).

    python3 scripts/torch_ladder_ab.py [--parent DIR] [--other NAME=CSRC]
                                       [--time-only NAME=CSRC] [--sass DIR]

Builds this tree's two sources, and with --parent the same two files of
another checkout (the bit-by-bit ladder before the windowed body), with
each --other those of another csrc directory (a variant of the windowed
body) and with each --time-only one whose outputs are not held
(scripts/torch_ab_harness.py: the options, builds, turns and timing it
shares with torch_k1_sweep_ab.py); prints ptxas's report of the ladder
kernels and of every function that spills; with --sass, writes each
tree's SASS (cuobjdump -sass) to DIR/NAME.sass and prints, for each
function of the G2 ladder's object, its instructions and its local-memory
loads and stores.  Then, at the paths' shapes:

- K2 at 256 rows of 64-bit weights (chip_smoke.py K2_TIMED: a full
  block's weighting sweep);
- K2 at the blob verify's lincomb, 6 points padded to 8 with infinity and
  scalar 0, 255-bit scalars: the parent's 256-bit rows, this tree's rows
  split by GLV (curve_torch.glv_bits);
- the G2 ladder at the staged flush's 16 rows of 64-bit weights (14 set
  coefficients and two zero rows);
- the G2 ladder over h_eff on one hashed point (636 bits);

this tree's outputs equal their plain versions (curve_torch.windowed_ladder,
glv_ladder) bit for bit, every tree's outputs equal the host oracle's
multiples (compressed bytes), and each launch is timed by CUDA events from
a CUDA graph on packed words, the trees in turn and then in the reverse
order (parent, this tree, this tree, parent).  Prints the card's name and
power limit, then a line a tree, shape and turn.  Needs a CUDA card; exits non-zero without one or on any
difference.
"""
import ctypes
import os
import sys

import numpy as np
import torch

import torch_ab_harness as ab
from consensus_specs_tpu_torch.crypto import curve as cv
from consensus_specs_tpu_torch.crypto import hash_to_curve as h2c
from consensus_specs_tpu_torch.crypto.fields import R
from consensus_specs_tpu_torch.ops import fq
from consensus_specs_tpu_torch.ops import curve_torch as ct

SEED = 2026
SOURCES = ("bls381_msm.cu", "bls381_g2.cu")
P, I64 = ctypes.c_void_p, ctypes.c_int64


class Tree:
    """One tree's launchers on packed words (split: this tree's K2)."""

    def __init__(self, name, csrc):
        self.name = name
        self.new = os.path.exists(os.path.join(csrc, "bls381_ladder.cuh"))
        self.lib, self.objs, self.ptxas = ab.build(
            csrc, SOURCES, os.path.join(ab.ROOT, "build", "ladder_ab", name),
            ("ladder",))
        self.lib.bls381_g1_ladder_launch.argtypes = (
            [P, P, I64, P, I64, ctypes.c_int, P] if self.new
            else [P, P, I64, P, I64, P])
        self.lib.bls381_g2_ladder_launch.argtypes = [P, P, I64, P, I64, P]
        for fn in (self.lib.bls381_g1_ladder_launch,
                   self.lib.bls381_g2_ladder_launch):
            fn.restype = ctypes.c_int

    def launch(self, g2, words, bits, out, split):
        stream = torch.cuda.current_stream().cuda_stream
        n, nbits = words.shape[0], bits.shape[-1]
        args = [words.data_ptr(), bits.data_ptr(), nbits, out.data_ptr(), n]
        if g2:
            rc = self.lib.bls381_g2_ladder_launch(*args, stream)
        elif self.new:
            rc = self.lib.bls381_g1_ladder_launch(*args, int(split), stream)
        else:
            rc = self.lib.bls381_g1_ladder_launch(*args, stream)
        if rc:
            raise RuntimeError(f"{self.name}: launch failed, CUDA error {rc}")


def sass_counts(tree, path):
    """Write the SASS of the tree's G2 ladder object to `path` and print
    each function's instructions, local loads (LDL) and stores (STL)."""
    sass = ab.cuobjdump_sass(tree.objs[SOURCES.index("bls381_g2.cu")])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(sass)
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = [0, 0, 0]
        elif name and line.strip().startswith("/*") and "*/" in line \
                and ";" in line:
            op = line.split("*/", 1)[1].split()
            op = op[1] if op and op[0].startswith("@") else \
                (op[0] if op else "")
            counts[name][0] += 1
            counts[name][1] += op.startswith("LDL")
            counts[name][2] += op.startswith("STL")
    for fn, (n, ldl, stl) in counts.items():
        print(f"  sass {tree.name} {fn}: {n} instructions, {ldl} LDL, "
              f"{stl} STL", flush=True)


def _multiples(gen, n, tag):
    rng = np.random.default_rng([SEED, tag, n])
    return [gen * int(k) for k in rng.integers(1, 2**62, size=n)]


def shapes():
    """name: (g2, points, scalars, nbits of the unsplit rows, reps)."""
    rng = np.random.default_rng([SEED, 13])
    weights = [int(c) for c in rng.integers(1, 2**63, 256, dtype=np.uint64)]
    blob_pts = _multiples(cv.g1_generator(), 6, 17) + [cv.g1_infinity()] * 2
    rng = np.random.default_rng([SEED, 17])
    blob_sc = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(6)]
    rng = np.random.default_rng([SEED, 19])
    coeffs = [int(c) for c in rng.integers(1, 2**63, 14, dtype=np.uint64)]
    u0, u1 = h2c.hash_to_field_fq2(b"ladder a/b", 2, h2c.DST_G2)
    hashed = h2c.iso_map(*h2c.sswu_map(u0)) + h2c.iso_map(*h2c.sswu_map(u1))
    return {
        "K2, 256 rows of 64 bits": (
            False, _multiples(cv.g1_generator(), 256, 13), weights, 64, 10),
        "K2, the blob verify's 8 rows of 256 bits": (
            False, blob_pts, blob_sc + [0, 0], 256, 10),
        "G2 ladder, 16 rows of 64 bits": (
            True, _multiples(cv.g2_generator(), 16, 19), coeffs + [0, 0], 64,
            5),
        "G2 ladder, h_eff on one point": (
            True, [hashed], [h2c.H_EFF], 636, 3)}


def main():
    parser = ab.parser(__doc__.split("\n\n")[0])
    parser.add_argument("--sass", help="write each tree's SASS here")
    args = parser.parse_args()
    ab.card()
    trees, unheld = ab.trees(args, Tree)
    if args.sass:
        for tree in trees.values():
            sass_counts(tree, os.path.join(args.sass, tree.name + ".sass"))
    cases = {}
    for label, (g2, pts, scalars, nbits, reps) in shapes().items():
        pack = ct.g2_pack if g2 else ct.g1_pack
        pt = pack(pts, "cuda")
        words = fq.to_words(torch.stack(pt, dim=1)).contiguous()
        split = not g2 and nbits == 256
        bits = {name: (ct.glv_bits(scalars, "cuda") if split and tree.new
                       else ct.scalars_to_bits(scalars, nbits, "cuda"))
                for name, tree in trees.items()}
        want = [cv.g2_to_bytes(p * s) if g2 else cv.g1_to_bytes(p * s)
                for p, s in zip(pts, scalars)]
        outs = {}
        for name, tree in trees.items():
            out = torch.empty_like(words)
            tree.launch(g2, words, bits[name].contiguous(), out, split)
            torch.cuda.synchronize()
            got = fq.from_words(out).unbind(1)
            unpack, enc = ((ct.g2_unpack, cv.g2_to_bytes) if g2
                           else (ct.g1_unpack, cv.g1_to_bytes))
            if name not in unheld and [enc(p) for p in unpack(
                    tuple(c.cpu() for c in got))] != want:
                sys.exit(f"{name}, {label}: != the host oracle's multiples")
            if name == "this tree":
                F = ct.F2 if g2 else ct.F1
                plain = (ct.glv_ladder(pt, bits[name]) if split
                         else ct.windowed_ladder(F, pt, bits[name]))
                if any(not torch.equal(a, b) for a, b in zip(got, plain)):
                    sys.exit(f"{name}, {label}: != its plain version")
            outs[name] = out
        print(f"{label}: == the host oracle's multiples in "
              f"{', '.join(n for n in trees if n not in unheld)}; this tree "
              f"== its plain version bit for bit", flush=True)
        cases[label] = (g2, words, bits, outs, split, reps)
    order = ab.turns(trees)
    for label, (g2, words, bits, outs, split, reps) in cases.items():
        for turn, name in enumerate(order):
            tree, b, out = trees[name], bits[name].contiguous(), outs[name]
            ms = ab.graph_ms(lambda: tree.launch(g2, words, b, out, split),
                              reps)
            print(f"{label}, {name} (turn {turn + 1}): {ms:.6f} ms from a "
                  f"CUDA graph, {reps} launches", flush=True)


if __name__ == "__main__":
    main()
