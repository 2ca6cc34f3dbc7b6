"""Build the port's CUDA kernels and hand out their launchers.

Every hand-written kernel of the port (`csrc/*.cu`, CUDA C++ for sm_90a) is
built from the package's own sources at first use, all into one extension
or library under `build/torch_ext/` beside the package:

- with `torch.utils.cpp_extension.load` where `ninja` is installed, the
  kernels' sources plus one small binding file (`csrc/kernels_bind.cpp`, the
  only source that includes PyTorch's headers);
- else with one `nvcc` a source, all started together, linked with
  `nvcc -shared` into a plain C library loaded with ctypes.

Nothing is built while this module is imported.  `build()` returns the
launchers; the wrappers in `sha256_cuda.py` and `epoch_sweep_cuda.py` check
their tensors before they call one, and raise on a refused launch.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from types import SimpleNamespace

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
KERNEL_SOURCES = tuple(os.path.join(CSRC, name) for name in (
    "sha256_pairs.cu", "sha256_gather.cu", "epoch_sweep.cu"))
BINDING_SOURCE = os.path.join(CSRC, "kernels_bind.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "torch_ext")
ARCH_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

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
    ext = cpp_extension.load(
        name="port_kernels_ext",
        sources=[*KERNEL_SOURCES, BINDING_SOURCE],
        build_directory=BUILD_DIR,
        extra_cuda_cflags=ARCH_FLAGS,
        verbose=False)

    def epoch(params, like):
        return ext.epoch_sweep(torch.from_numpy(params), like)
    return SimpleNamespace(pairs=ext.sha256_pairs, gather=ext.sha256_gather,
                           epoch=epoch)


def _nvcc(nvcc, args):
    return subprocess.Popen([nvcc, *ARCH_FLAGS, "-std=c++17", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _wait(proc):
    _out, err = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{err}")


def _build_ctypes():
    from torch.utils import cpp_extension
    nvcc = os.path.join(cpp_extension.CUDA_HOME or "/usr/local/cuda",
                        "bin", "nvcc")
    objects = [os.path.join(BUILD_DIR, os.path.basename(src) + ".o")
               for src in KERNEL_SOURCES]
    compiles = [_nvcc(nvcc, ["-c", "-Xcompiler", "-fPIC", "-o", obj, src])
                for src, obj in zip(KERNEL_SOURCES, objects)]
    for proc in compiles:
        _wait(proc)
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
    return SimpleNamespace(pairs=pairs, gather=gather, epoch=epoch)


def build():
    """Build every kernel (once per process) and return their launchers:
    `.pairs(chunks, out)`, `.gather(pool, idx_l, idx_r, out_offset)` and
    `.epoch(params, like)`, which takes the int64 numpy parameter array of
    `epoch_sweep_cuda.PARAMS` and a tensor on the sweep's device, and
    returns the number of kernels it launched."""
    global _kernels, build_route
    if _kernels is None:
        from torch.utils import cpp_extension
        os.makedirs(BUILD_DIR, exist_ok=True)
        if cpp_extension.is_ninja_available():
            _kernels, build_route = _build_cpp_extension(), "cpp_extension"
        else:
            _kernels, build_route = _build_ctypes(), "ctypes"
    return _kernels
