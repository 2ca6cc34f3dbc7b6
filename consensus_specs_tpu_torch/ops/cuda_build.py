"""Build the port's CUDA kernels and hand out their launchers.

Every hand-written kernel of the port (`csrc/*.cu`, CUDA C++ for sm_90a) is
built from the package's own sources at first use, all into one extension
or library under `build/torch_ext/` beside the package:

- with `torch.utils.cpp_extension.load` where `ninja` is installed, the
  kernels' sources plus one small binding file (`csrc/kernels_bind.cpp`, the
  only source that includes PyTorch's headers);
- else with one `nvcc` a source, all started together, linked with
  `nvcc -shared` into a plain C library loaded with ctypes.

Every compile passes `-Xptxas=-v`, and the build's output, ptxas's report
of each function's registers, stack and spill stores and loads among it,
is kept in `build/torch_ext/build.log` (`BUILD_LOG`).

Nothing is built while this module is imported.  `build()` returns the
launchers; the wrappers in `sha256_cuda.py`, `epoch_sweep_cuda.py` and
`bls381_cuda.py` check their tensors before they call one, and raise on a
refused launch.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from types import SimpleNamespace

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
KERNEL_SOURCES = tuple(os.path.join(CSRC, name) for name in (
    "sha256_pairs.cu", "sha256_gather.cu", "epoch_sweep.cu",
    "bls381_pairing.cu", "bls381_g2.cu", "bls381_field.cu", "bls381_msm.cu",
    "bls381_fold.cu", "bls381_cofactor.cu", "bls381_check.cu",
    "bls381_pippenger.cu"))
BINDING_SOURCE = os.path.join(CSRC, "kernels_bind.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "torch_ext")
BUILD_LOG = os.path.join(BUILD_DIR, "build.log")
ARCH_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]
BUILD_FLAGS = [*ARCH_FLAGS, "-Xptxas=-v"]

_kernels = None     # SimpleNamespace of launchers, once built
build_route = None  # "cpp_extension" or "ctypes", once built


def require_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on the CUDA card by default and none is "
            "available; call consensus_specs_tpu_torch.set_device('cpu') "
            "to run the plain torch versions on the host")
    return device


def _check(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _build_cpp_extension():
    from torch.utils import cpp_extension
    # verbose, with file descriptor 1 on the build log: ninja prints each
    # command line there, then its compiler's output
    sys.stdout.flush()
    saved = os.dup(1)
    try:
        with open(BUILD_LOG, "w") as log:
            os.dup2(log.fileno(), 1)
            ext = cpp_extension.load(
                name="port_kernels_ext",
                sources=[*KERNEL_SOURCES, BINDING_SOURCE],
                build_directory=BUILD_DIR,
                extra_cuda_cflags=BUILD_FLAGS,
                verbose=True)
    except Exception as err:
        with open(BUILD_LOG) as log:
            tail = log.read()[-6000:]
        raise RuntimeError(f"building the kernels failed:\n{tail}") from err
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)

    def epoch(params, like):
        return ext.epoch_sweep(torch.from_numpy(params), like)

    def field(op, a, b, out, n):
        ext.bls381_field(op, a, a if b is None else b, b is not None, out,
                         n)
    return SimpleNamespace(
        pairs=ext.sha256_pairs, gather=ext.sha256_gather, epoch=epoch,
        field=field, ladder=ext.bls381_ladder, miller=ext.bls381_miller,
        final=ext.bls381_final, segment_sum=ext.bls381_segment_sum,
        g1_ladder=ext.bls381_g1_ladder, fold_lanes=ext.bls381_fold_lanes,
        fold_tail=ext.bls381_fold_tail,
        clear_cofactor=ext.bls381_clear_cofactor,
        pairing_check=ext.bls381_pairing_check,
        pippenger_fold=ext.bls381_pippenger_fold,
        pippenger_window=ext.bls381_pippenger_window,
        pippenger_horner=ext.bls381_pippenger_horner)


def _nvcc(nvcc, args):
    return subprocess.Popen([nvcc, *BUILD_FLAGS, "-std=c++17", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _wait(proc):
    _out, err = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{err}")
    return err


def _build_ctypes():
    from torch.utils import cpp_extension
    nvcc = os.path.join(cpp_extension.CUDA_HOME or "/usr/local/cuda",
                        "bin", "nvcc")
    objects = [os.path.join(BUILD_DIR, os.path.basename(src) + ".o")
               for src in KERNEL_SOURCES]
    compiles = [_nvcc(nvcc, ["-c", "-Xcompiler", "-fPIC", "-o", obj, src])
                for src, obj in zip(KERNEL_SOURCES, objects)]
    with open(BUILD_LOG, "w") as log:
        for src, proc in zip(KERNEL_SOURCES, compiles):
            log.write(f"[nvcc] -c {src} \n{_wait(proc)}")
    lib_path = os.path.join(BUILD_DIR, "libport_kernels.so")
    _wait(_nvcc(nvcc, ["-shared", "-o", lib_path, *objects]))
    lib = ctypes.CDLL(lib_path)
    pairs_fn = lib.sha256_pairs_launch
    pairs_fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                         ctypes.c_void_p]
    pairs_fn.restype = ctypes.c_int
    gather_fn = lib.sha256_gather_launch
    gather_fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    gather_fn.restype = ctypes.c_int
    epoch_fn = lib.epoch_sweep_launch
    epoch_fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    epoch_fn.restype = ctypes.c_int
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    field_fn = lib.bls381_field_launch
    field_fn.argtypes = [ctypes.c_int, ptr, ptr, ptr, i64, ptr]
    ladder_fn = lib.bls381_g2_ladder_launch
    ladder_fn.argtypes = [ptr, ptr, i64, ptr, i64, ptr]
    miller_fn = lib.bls381_miller_launch
    miller_fn.argtypes = [ptr, ptr, ptr, ptr, i64, ptr]
    final_fn = lib.bls381_final_launch
    final_fn.argtypes = [ptr, i64, ctypes.c_int, ptr, ptr, i64, ptr]
    segment_fn = lib.bls381_segment_sum_launch
    segment_fn.argtypes = [ctypes.c_int, ptr, i64, ptr, i64, ptr]
    g1_ladder_fn = lib.bls381_g1_ladder_launch
    g1_ladder_fn.argtypes = [ptr, ptr, i64, ptr, i64, ptr]
    lanes_fn = lib.bls381_fold_lanes_launch
    lanes_fn.argtypes = [ptr, ptr, i64, ptr, ptr, ptr, i64, ptr, ptr, ptr,
                         ptr, ptr, i64, ptr]
    tail_fn = lib.bls381_fold_tail_launch
    tail_fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, ptr]
    cofactor_fn = lib.bls381_clear_cofactor_launch
    cofactor_fn.argtypes = [ptr, ptr, ptr, ptr, i64, ptr]
    check_fn = lib.bls381_pairing_check_launch
    check_fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, ptr]
    pip_fold_fn = lib.bls381_pippenger_fold_launch
    pip_fold_fn.argtypes = [ptr, ptr, i64, ptr, ptr]
    pip_window_fn = lib.bls381_pippenger_window_launch
    pip_window_fn.argtypes = [ptr, ptr, ptr, ptr]
    pip_horner_fn = lib.bls381_pippenger_horner_launch
    pip_horner_fn.argtypes = [ptr, ptr, ptr]
    for fn in (field_fn, ladder_fn, miller_fn, final_fn, segment_fn,
               g1_ladder_fn, lanes_fn, tail_fn, cofactor_fn, check_fn,
               pip_fold_fn, pip_window_fn, pip_horner_fn):
        fn.restype = ctypes.c_int

    def stream_of(t):
        return torch.cuda.current_stream(t.device).cuda_stream

    def pairs(chunks, out):
        _check("sha256_pairs", pairs_fn(chunks.data_ptr(), out.data_ptr(),
                                        out.shape[0], stream_of(chunks)))

    def gather(pool, idx_l, idx_r, out_offset):
        _check("sha256_gather", gather_fn(
            pool.data_ptr(), idx_l.data_ptr(), idx_r.data_ptr(), out_offset,
            idx_l.shape[0], stream_of(pool)))

    def epoch(params, like):
        launched = ctypes.c_int(0)
        with torch.cuda.device(like.device):
            _check("epoch_sweep", epoch_fn(
                params.ctypes.data, ctypes.addressof(launched),
                stream_of(like)))
        return launched.value

    def field(op, a, b, out, n):
        with torch.cuda.device(a.device):
            _check("bls381_field", field_fn(
                op, a.data_ptr(), None if b is None else b.data_ptr(),
                out.data_ptr(), n, stream_of(a)))

    def ladder(pts, bits, nbits, out, n):
        with torch.cuda.device(pts.device):
            _check("bls381_g2", ladder_fn(
                pts.data_ptr(), bits.data_ptr(), nbits, out.data_ptr(), n,
                stream_of(pts)))

    def miller(g1, g2, skip, f, n):
        with torch.cuda.device(g1.device):
            _check("bls381_pairing (Miller loop)", miller_fn(
                g1.data_ptr(), g2.data_ptr(), skip.data_ptr(), f.data_ptr(),
                n, stream_of(g1)))

    def final(f, k, do_final, prod, ok, b):
        with torch.cuda.device(f.device):
            _check("bls381_pairing (final exponentiation)", final_fn(
                f.data_ptr(), k, int(do_final), prod.data_ptr(),
                ok.data_ptr(), b, stream_of(f)))
    def segment_sum(g2, buf, length, out, segments):
        with torch.cuda.device(buf.device):
            _check("bls381_msm (segment sum)", segment_fn(
                int(g2), buf.data_ptr(), length, out.data_ptr(), segments,
                stream_of(buf)))

    def g1_ladder(pts, bits, nbits, out, n):
        with torch.cuda.device(pts.device):
            _check("bls381_msm (G1 ladder)", g1_ladder_fn(
                pts.data_ptr(), bits.data_ptr(), nbits, out.data_ptr(), n,
                stream_of(pts)))

    def fold_lanes(agg, cbits, ncbits, hq, sig, hbits, nh, consts, g1, g2,
                   skip, sw, k):
        with torch.cuda.device(agg.device):
            _check("bls381_fold (lanes)", lanes_fn(
                agg.data_ptr(), cbits.data_ptr(), ncbits, hq.data_ptr(),
                sig.data_ptr(), hbits.data_ptr(), nh, consts.data_ptr(),
                g1.data_ptr(), g2.data_ptr(), skip.data_ptr(), sw.data_ptr(),
                k, stream_of(agg)))

    def fold_tail(S, consts, g1, g2, skip, k):
        with torch.cuda.device(S.device):
            _check("bls381_fold (tail)", tail_fn(
                S.data_ptr(), consts.data_ptr(), g1.data_ptr(),
                g2.data_ptr(), skip.data_ptr(), k, stream_of(S)))

    def clear_cofactor(pts, consts, xy, inf, n):
        with torch.cuda.device(pts.device):
            _check("bls381_cofactor", cofactor_fn(
                pts.data_ptr(), consts.data_ptr(), xy.data_ptr(),
                inf.data_ptr(), n, stream_of(pts)))

    def pairing_check(g1, g2, skip, tq, prod, ok, k, b):
        with torch.cuda.device(g1.device):
            _check("bls381_check", check_fn(
                g1.data_ptr(), g2.data_ptr(), skip.data_ptr(), tq.data_ptr(),
                prod.data_ptr(), ok.data_ptr(), k, b, stream_of(g1)))

    def pippenger_fold(pts, digits, n, tables):
        with torch.cuda.device(pts.device):
            _check("bls381_pippenger (fold)", pip_fold_fn(
                pts.data_ptr(), digits.data_ptr(), n, tables.data_ptr(),
                stream_of(pts)))

    def pippenger_window(tables, scan, G):
        with torch.cuda.device(tables.device):
            _check("bls381_pippenger (window)", pip_window_fn(
                tables.data_ptr(), scan.data_ptr(), G.data_ptr(),
                stream_of(tables)))

    def pippenger_horner(G, out):
        with torch.cuda.device(G.device):
            _check("bls381_pippenger (Horner)", pip_horner_fn(
                G.data_ptr(), out.data_ptr(), stream_of(G)))
    return SimpleNamespace(pairs=pairs, gather=gather, epoch=epoch,
                           field=field, ladder=ladder, miller=miller,
                           final=final, segment_sum=segment_sum,
                           g1_ladder=g1_ladder, fold_lanes=fold_lanes,
                           fold_tail=fold_tail,
                           clear_cofactor=clear_cofactor,
                           pairing_check=pairing_check,
                           pippenger_fold=pippenger_fold,
                           pippenger_window=pippenger_window,
                           pippenger_horner=pippenger_horner)


def build():
    """Build every kernel (once per process) and return their launchers:
    `.pairs(chunks, out)`, `.gather(pool, idx_l, idx_r, out_offset)`,
    `.epoch(params, like)`, which takes the int64 numpy parameter array of
    `epoch_sweep_cuda.PARAMS` and a tensor on the sweep's device, and
    returns the number of kernels it launched, and the BLS12-381 kernels'
    `.field(op, a, b, out, n)` (b None for a unary op), `.ladder(pts,
    bits, nbits, out, n)`, `.miller(g1, g2, skip, f, n)` and `.final(f, k,
    do_final, prod, ok, b)`, `.segment_sum(g2, buf, length, out,
    segments)`, `.g1_ladder(pts, bits, nbits, out, n)`, `.fold_lanes(agg,
    cbits, ncbits, hq, sig, hbits, nh, consts, g1, g2, skip, sw, k)`,
    `.fold_tail(S, consts, g1, g2, skip, k)`, `.clear_cofactor(pts, consts,
    xy, inf, n)`, `.pairing_check(g1, g2, skip, tq, prod, ok, k, b)` and
    the Pippenger MSM's `.pippenger_fold(pts, digits, n, tables)`,
    `.pippenger_window(tables, scan, G)` and `.pippenger_horner(G, out)`
    (bls381_cuda.py gives the layouts)."""
    global _kernels, build_route
    if _kernels is None:
        from torch.utils import cpp_extension
        os.makedirs(BUILD_DIR, exist_ok=True)
        if cpp_extension.is_ninja_available():
            _kernels, build_route = _build_cpp_extension(), "cpp_extension"
        else:
            _kernels, build_route = _build_ctypes(), "ctypes"
    return _kernels
