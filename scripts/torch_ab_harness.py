"""What the A/B scripts (torch_ladder_ab.py, torch_k1_sweep_ab.py) share:
the trees' options, their builds, the turn order and the timing.

A tree is a csrc directory: this tree's, with --parent DIR that of another
checkout (DIR its root), with each --other NAME=CSRC a variant held like
the others, and with each --time-only NAME=CSRC a variant that is timed
but not held (one that leaves a part out, to cost it).  Each tree's
sources are built with nvcc (sm_90a, -Xptxas=-v, the port's flags; one
nvcc a file, every tree's started together) into one library a tree,
loaded with ctypes.  The trees are timed by CUDA events from a CUDA graph,
in turn and then in the reverse order (parent, this tree, the variants,
then back), so that a drift of the card's clock shows as a difference
between a tree's two turns.
"""
import argparse
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from consensus_specs_tpu_torch.ops import cuda_build  # noqa: E402


def parser(description):
    """The options every A/B script takes; a script adds its own."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--parent", help="a checkout of the parent tree")
    p.add_argument("--other", action="append", default=[],
                   metavar="NAME=CSRC", help="another csrc directory")
    p.add_argument("--time-only", action="append", default=[],
                   metavar="NAME=CSRC", help="a variant timed, not held "
                   "(one that computes something else, to cost a part)")
    return p


def card():
    """Exit without a CUDA card; else print its name and power limit."""
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True).stdout.strip(), flush=True)


def tool(name):
    from torch.utils import cpp_extension
    return os.path.join(cpp_extension.CUDA_HOME or "/usr/local/cuda", "bin",
                        name)


def build(csrc, sources, out_dir, entry_words):
    """`sources` of csrc as one ctypes library in out_dir: (library,
    objects, ptxas lines of the kernel entries whose names hold one of
    `entry_words`, and of every function that spills)."""
    nvcc = tool("nvcc")
    os.makedirs(out_dir, exist_ok=True)
    objs = [os.path.join(out_dir, f + ".o") for f in sources]
    procs = [cuda_build._nvcc(nvcc, ["-c", "-Xcompiler", "-fPIC", "-o", o,
                                     os.path.join(csrc, f)])
             for f, o in zip(sources, objs)]
    report = "".join(cuda_build._wait(p) for p in procs)
    lib_path = os.path.join(out_dir, "libab.so")
    cuda_build._wait(cuda_build._nvcc(nvcc, ["-shared", "-o", lib_path,
                                             *objs]))
    lines = report.splitlines()
    keep = [" | ".join(ln.strip() for ln in lines[i:i + 4])
            for i, ln in enumerate(lines)
            if "Compiling entry" in ln and any(w in ln for w in entry_words)]
    keep += [f"{a.split()[-1]}: {b.strip()}" for a, b in zip(lines, lines[1:])
             if "Function properties" in a and "spill" in b
             and " 0 bytes spill stores" not in b]
    return ctypes.CDLL(lib_path), objs, keep


def cuobjdump_sass(obj):
    """The SASS of a built object (cuobjdump -sass)."""
    return subprocess.run([tool("cuobjdump"), "-sass", obj],
                          capture_output=True, text=True, check=True).stdout


def trees(args, make):
    """{name: make(name without spaces, csrc)} of every tree the options
    name, built at once; and the names of the trees not held.  Prints
    each tree's ptxas lines (its `.ptxas`)."""
    dirs = {"this tree": cuda_build.CSRC}
    if args.parent:
        dirs["parent"] = os.path.join(args.parent, "consensus_specs_tpu_torch",
                                      "ops", "csrc")
    dirs.update(o.split("=", 1) for o in args.other + args.time_only)
    unheld = {o.split("=", 1)[0] for o in args.time_only}
    with ThreadPoolExecutor(len(dirs)) as pool:
        builds = {name: pool.submit(make, name.replace(" ", "_"), csrc)
                  for name, csrc in dirs.items()}
        built = {name: b.result() for name, b in builds.items()}
    for name, tree in built.items():
        print(f"ptxas, {name}:", *tree.ptxas, sep="\n  ", flush=True)
    return built, unheld


def turns(built):
    """The order of the timed turns: parent first, then back."""
    names = sorted(built, key=lambda name: name != "parent")
    return names + names[::-1]


def graph_ms(fn, reps):
    """Mean ms of fn() over `reps` calls captured in one CUDA graph, after
    two calls on a side stream."""
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
