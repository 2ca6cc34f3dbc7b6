#!/usr/bin/env python3
"""The scalar ladders of two trees side by side on the card: K2 (the G1
ladder, ops/csrc/bls381_msm.cu) and the G2 ladder (ops/csrc/bls381_g2.cu).

    python3 scripts/torch_ladder_ab.py [--parent DIR] [--other NAME=CSRC]
                                       [--time-only NAME=CSRC] [--sass DIR]

Builds this tree's two sources, and with --parent the same two files of
another checkout (the bit-by-bit ladder before the windowed body), and
with each --other those of another csrc directory (a variant of the
windowed body; with --time-only one whose outputs are not held, a variant
that leaves a part out to cost it), with nvcc (sm_90a, -Xptxas=-v, one nvcc a file, all
started together) into a library a tree, loaded with ctypes; prints
ptxas's report of the ladder kernels and of every function that spills;
with --sass, writes each tree's SASS (cuobjdump -sass) to DIR/NAME.sass
and prints, for each function of the G2 ladder's object, its
instructions and its local-memory loads and stores.  Then, at the paths'
shapes:

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
order (parent, this tree, this tree, parent).  Prints the card's name and power limit, then a line a tree,
shape and turn.  Needs a CUDA card; exits non-zero without one or on any
difference.
"""
import argparse
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from consensus_specs_tpu_torch.crypto import curve as cv  # noqa: E402
from consensus_specs_tpu_torch.crypto import hash_to_curve as h2c  # noqa: E402
from consensus_specs_tpu_torch.crypto.fields import R  # noqa: E402
from consensus_specs_tpu_torch.ops import cuda_build, fq  # noqa: E402
from consensus_specs_tpu_torch.ops import curve_torch as ct  # noqa: E402

SEED = 2026
SOURCES = ("bls381_msm.cu", "bls381_g2.cu")
P, I64 = ctypes.c_void_p, ctypes.c_int64


def build(csrc, out_dir):
    """The two ladder sources of `csrc` as one ctypes library in out_dir:
    (library, ptxas lines of the ladder kernels)."""
    from torch.utils import cpp_extension
    nvcc = os.path.join(cpp_extension.CUDA_HOME or "/usr/local/cuda", "bin",
                        "nvcc")
    os.makedirs(out_dir, exist_ok=True)
    objs = [os.path.join(out_dir, f + ".o") for f in SOURCES]
    procs = [cuda_build._nvcc(nvcc, ["-c", "-Xcompiler", "-fPIC", "-o", o,
                                     os.path.join(csrc, f)])
             for f, o in zip(SOURCES, objs)]
    report = "".join(cuda_build._wait(p) for p in procs)
    lib_path = os.path.join(out_dir, "libladders.so")
    cuda_build._wait(cuda_build._nvcc(nvcc, ["-shared", "-o", lib_path,
                                             *objs]))
    lines = report.splitlines()
    keep = [" | ".join(ln.strip() for ln in lines[i:i + 4])
            for i, ln in enumerate(lines)
            if "ladder" in ln and "Compiling entry" in ln]
    keep += [f"{a.split()[-1]}: {b.strip()}" for a, b in zip(lines, lines[1:])
             if "Function properties" in a and "spill" in b
             and " 0 bytes spill stores" not in b]
    return ctypes.CDLL(lib_path), keep


class Tree:
    """One tree's launchers on packed words (split: this tree's K2)."""

    def __init__(self, name, csrc):
        self.name = name
        self.new = os.path.exists(os.path.join(csrc, "bls381_ladder.cuh"))
        self.lib, self.ptxas = build(
            csrc, os.path.join(ROOT, "build", "ladder_ab", name))
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
    from torch.utils import cpp_extension
    tool = os.path.join(cpp_extension.CUDA_HOME or "/usr/local/cuda", "bin",
                        "cuobjdump")
    obj = os.path.join(ROOT, "build", "ladder_ab", tree.name,
                       "bls381_g2.cu.o")
    sass = subprocess.run([tool, "-sass", obj], capture_output=True,
                          text=True, check=True).stdout
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


def graph_ms(fn, reps):
    """Mean ms of fn() over `reps` calls captured in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
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
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="a checkout of the parent tree")
    parser.add_argument("--other", action="append", default=[],
                        metavar="NAME=CSRC", help="another csrc directory")
    parser.add_argument("--sass", help="write each tree's SASS here")
    parser.add_argument("--time-only", action="append", default=[],
                        metavar="NAME=CSRC", help="a variant timed, not held "
                        "(one that computes something else, to cost a part)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True).stdout.strip(), flush=True)
    dirs = {"this tree": cuda_build.CSRC}
    if args.parent:
        dirs["parent"] = os.path.join(args.parent, "consensus_specs_tpu_torch",
                                      "ops", "csrc")
    dirs.update(o.split("=", 1) for o in args.other + args.time_only)
    unheld = {o.split("=", 1)[0] for o in args.time_only}
    with ThreadPoolExecutor(len(dirs)) as pool:   # every tree's nvcc at once
        builds = {name: pool.submit(Tree, name.replace(" ", "_"), csrc)
                  for name, csrc in dirs.items()}
        trees = {name: b.result() for name, b in builds.items()}
    for name, tree in trees.items():
        print(f"ptxas, {name}:", *tree.ptxas, sep="\n  ", flush=True)
        if args.sass:
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
    names = sorted(trees, key=lambda name: name != "parent")
    order = names + names[::-1]
    for label, (g2, words, bits, outs, split, reps) in cases.items():
        for turn, name in enumerate(order):
            tree, b, out = trees[name], bits[name].contiguous(), outs[name]
            ms = graph_ms(lambda: tree.launch(g2, words, b, out, split), reps)
            print(f"{label}, {name} (turn {turn + 1}): {ms:.6f} ms from a "
                  f"CUDA graph, {reps} launches", flush=True)


if __name__ == "__main__":
    main()
