#!/usr/bin/env python3
"""Dependent latency of one BLS12-381 Fq product in one warp on the card.

    python3 scripts/torch_fq_product_latency.py

Builds scripts/torch_fq_product_latency.cu with nvcc (sm_90a) and times,
by CUDA events, chains of 1,000 and 3,000 dependent Montgomery products in
one thread and in 32 threads of one warp, in three forms: the port's
register-resident product with PTX carry chains (ops/csrc/bls381_reg.cuh
rq_mul), the portable CIOS body and a carry-save form.  The three must
give the same words.  Prints the card's name and power limit, then a line
a form and shape with the nanoseconds a dependent product.  Needs a CUDA
card; exits non-zero without one.
"""
import ctypes
import os
import random
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from consensus_specs_tpu_torch.crypto.fields import Q  # noqa: E402
from consensus_specs_tpu_torch.ops import cuda_build, fq  # noqa: E402

FORMS = ("PTX carry chains (rq_mul)", "portable CIOS", "carry-save")


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True).stdout.strip())
    from torch.utils import cpp_extension
    nvcc = os.path.join(cpp_extension.CUDA_HOME or "/usr/local/cuda", "bin",
                        "nvcc")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    lib_path = os.path.join(out, "libfq_chain.so")
    subprocess.run([nvcc, *cuda_build.ARCH_FLAGS, "-std=c++17", "-shared",
                    "-Xcompiler", "-fPIC", "-I", cuda_build.CSRC, "-o",
                    lib_path, os.path.join(ROOT, "scripts",
                                           "torch_fq_product_latency.cu")],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    lib.fq_chain_launch.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    rng = random.Random(2026)
    words = fq.to_words(fq.pack_mont([rng.randrange(Q) for _ in range(64)]))
    words = words.reshape(32, 2 * fq.WORDS).contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    results = {}
    for threads in (1, 32):
        for iters in (1000, 3000):
            for form, name in enumerate(FORMS):
                data = words.cuda()
                if lib.fq_chain_launch(form, data.data_ptr(), 10, threads,
                                       stream):
                    sys.exit(f"{name}: launch failed")
                data = words.cuda()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                lib.fq_chain_launch(form, data.data_ptr(), iters, threads,
                                    stream)
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end)
                results[form, threads, iters] = data.cpu()
                print(f"{name}, {threads} thread(s), {iters} products: "
                      f"{ms:.6f} ms, {ms * 1e6 / iters:.1f} ns a dependent "
                      f"product", flush=True)
            same = all(torch.equal(results[0, threads, iters],
                                   results[f, threads, iters])
                       for f in (1, 2))
            if not same:
                sys.exit(f"the forms disagree at {threads} x {iters}")
    print("the three forms give the same words")


if __name__ == "__main__":
    main()
