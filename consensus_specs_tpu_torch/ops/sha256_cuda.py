"""The CUDA SHA-256 kernels: build, launch and count.

Counterpart of consensus_specs_tpu/ops/sha256_pallas.py and of the fused
sweep program in consensus_specs_tpu/ops/sha256.py.  Two kernels, written for
sm_90a, share one SHA-256 body (csrc/sha256_core.cuh):

- csrc/sha256_pairs.cu computes what the Pallas kernel computes, the 2-to-1
  hash of chunk pairs, int32[2N, 8] -> int32[N, 8] (uint32 bit patterns),
  with no padding of N;
- csrc/sha256_gather.cu computes one round of `_fused_rounds_device`: pairs
  gathered from a pool of chunks by index, hashed, and written back into the
  same pool at the round's offset.

Both are built from the package's own sources at first use, into one
extension or library under `build/torch_ext/` beside the package: with
`torch.utils.cpp_extension.load` where `ninja` is installed, else with one
`nvcc` a source, all started together, linked into a plain C library loaded
with ctypes.  Nothing is built while this module is imported.

`hash_pairs_cuda` and `hash_gather_pairs_cuda` are the wrappers.  On CUDA
tensors each launches its kernel or raises; on CPU tensors it runs the plain
version (ops/sha256.py), and only for that reason.  Each wrapper's
`.launches` counts kernel launches and `.plain_calls` counts calls that took
the plain version.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from types import SimpleNamespace

import torch

from . import sha256

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
KERNEL_SOURCE = os.path.join(_CSRC, "sha256_pairs.cu")
GATHER_SOURCE = os.path.join(_CSRC, "sha256_gather.cu")
CORE_SOURCE = os.path.join(_CSRC, "sha256_core.cuh")
BINDING_SOURCE = os.path.join(_CSRC, "sha256_pairs_bind.cpp")
KERNEL_SOURCES = (KERNEL_SOURCE, GATHER_SOURCE)
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "torch_ext")
ARCH_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

_kernels = None     # SimpleNamespace(pairs=..., gather=...), once built
build_route = None  # "cpp_extension" or "ctypes", once built


def _build_cpp_extension():
    from torch.utils import cpp_extension
    ext = cpp_extension.load(
        name="sha256_kernels_ext",
        sources=[*KERNEL_SOURCES, BINDING_SOURCE],
        build_directory=BUILD_DIR,
        extra_cuda_cflags=ARCH_FLAGS,
        verbose=False)
    return SimpleNamespace(pairs=ext.sha256_pairs, gather=ext.sha256_gather)


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
    lib_path = os.path.join(BUILD_DIR, "libsha256_kernels.so")
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

    def check(name, rc):
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")

    def pairs(chunks, out):
        stream = torch.cuda.current_stream(chunks.device).cuda_stream
        check("sha256_pairs", pairs_fn(chunks.data_ptr(), out.data_ptr(),
                                       out.shape[0], stream))

    def gather(pool, idx_l, idx_r, out_offset):
        stream = torch.cuda.current_stream(pool.device).cuda_stream
        check("sha256_gather", gather_fn(
            pool.data_ptr(), idx_l.data_ptr(), idx_r.data_ptr(), out_offset,
            idx_l.shape[0], stream))
    return SimpleNamespace(pairs=pairs, gather=gather)


def build():
    """Build both kernels (once per process) and return their launchers,
    `.pairs(chunks, out)` and `.gather(pool, idx_l, idx_r, out_offset)`."""
    global _kernels, build_route
    if _kernels is None:
        from torch.utils import cpp_extension
        os.makedirs(BUILD_DIR, exist_ok=True)
        if cpp_extension.is_ninja_available():
            _kernels, build_route = _build_cpp_extension(), "cpp_extension"
        else:
            _kernels, build_route = _build_ctypes(), "ctypes"
    return _kernels


def _require_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port hashes on the CUDA card by default and none is "
            "available; call consensus_specs_tpu_torch.set_device('cpu') "
            "to hash with the plain torch version on the host")
    return device


def hash_pairs_cuda(chunks: torch.Tensor) -> torch.Tensor:
    """2-to-1 hash of adjacent chunk pairs: int32[2N, 8] -> int32[N, 8].

    A CUDA tensor goes through the kernel, a CPU tensor through the plain
    version.  Rejects an odd row count, a dtype other than int32, a device
    other than cpu or cuda, and a non-contiguous or (on the card)
    misaligned tensor."""
    if chunks.dim() != 2 or chunks.shape[1] != 8 or chunks.shape[0] % 2:
        raise ValueError(f"expected int32[2N, 8] chunks, got shape "
                         f"{tuple(chunks.shape)}")
    if chunks.dtype != torch.int32:
        raise TypeError(f"expected int32 chunks, got {chunks.dtype}")
    if not chunks.is_contiguous():
        raise ValueError("chunks must be contiguous")
    if chunks.device.type == "cpu":
        hash_pairs_cuda.plain_calls += 1
        return sha256.hash_pairs(chunks)
    if chunks.device.type != "cuda":
        raise ValueError(f"chunks on unsupported device {chunks.device}")
    if chunks.data_ptr() % 16:
        raise ValueError("chunks must be 16-byte aligned on the card")
    kernels = build()
    out = torch.empty((chunks.shape[0] // 2, 8), dtype=torch.int32,
                      device=chunks.device)
    if out.shape[0]:
        kernels.pairs(chunks, out)
        hash_pairs_cuda.launches += 1
    return out


hash_pairs_cuda.launches = 0
hash_pairs_cuda.plain_calls = 0


def hash_gather_pairs_cuda(pool: torch.Tensor, idx_l: torch.Tensor,
                           idx_r: torch.Tensor,
                           out_offset: int) -> torch.Tensor:
    """One round of a fused sweep, in place: for k < n,
    pool[out_offset + k] = SHA-256(pool[idx_l[k]] || pool[idx_r[k]]).
    Returns the n rows written (a view of `pool`).

    Every index must name a row below `out_offset` (a literal or an earlier
    round's output); the caller checks that on the host (fused_rounds).
    CUDA tensors go through the kernel, CPU tensors through the plain
    version.  Rejects a pool that is not int32[P, 8], indices that are not
    two int32 vectors of one length, tensors on different or unsupported
    devices, a non-contiguous or (on the card) misaligned tensor, and an
    output range outside the pool."""
    if pool.dim() != 2 or pool.shape[1] != 8:
        raise ValueError(f"expected an int32[P, 8] pool, got shape "
                         f"{tuple(pool.shape)}")
    if idx_l.dim() != 1 or idx_l.shape != idx_r.shape:
        raise ValueError(f"expected two index vectors of one length, got "
                         f"{tuple(idx_l.shape)} and {tuple(idx_r.shape)}")
    for t in (pool, idx_l, idx_r):
        if t.dtype != torch.int32:
            raise TypeError(f"expected int32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("pool and indices must be contiguous")
        if t.device != pool.device:
            raise ValueError(f"pool on {pool.device}, indices on {t.device}")
    n = idx_l.shape[0]
    if out_offset < 0 or out_offset + n > pool.shape[0]:
        raise ValueError(f"output rows [{out_offset}, {out_offset + n}) "
                         f"outside a pool of {pool.shape[0]} rows")
    out = pool[out_offset:out_offset + n]
    if pool.device.type == "cpu":
        hash_gather_pairs_cuda.plain_calls += 1
        out.copy_(sha256.hash_gather_pairs(pool, idx_l, idx_r))
        return out
    if pool.device.type != "cuda":
        raise ValueError(f"pool on unsupported device {pool.device}")
    if pool.data_ptr() % 16:
        raise ValueError("pool must be 16-byte aligned on the card")
    kernels = build()
    if n:
        kernels.gather(pool, idx_l, idx_r, int(out_offset))
        hash_gather_pairs_cuda.launches += 1
    return out


hash_gather_pairs_cuda.launches = 0
hash_gather_pairs_cuda.plain_calls = 0


def merkle_tree_root_cuda(chunks: torch.Tensor, depth: int) -> torch.Tensor:
    """Balanced-tree root over int32[2**depth, 8] chunks: one launch a level,
    the levels staying on the tensor's device."""
    level = chunks
    for _ in range(depth):
        level = hash_pairs_cuda(level)
    return level[0]


def hash_level_cuda(data: bytes, device) -> bytes:
    """Bulk level hasher for ssz.merkle: 2N concatenated chunks -> N parents,
    hashed on `device`."""
    words = sha256.words_from_numpy(sha256.bytes_to_words(data),
                                    _require_device(device))
    return sha256.words_to_bytes(hash_pairs_cuda(words))


def merkle_root_cuda(data: bytes, device) -> bytes:
    """Subtree hasher for ssz.merkle: root of a power-of-two chunk array.
    Uploads the level once, hashes every level on `device` and downloads
    the 32-byte root (mesh_engine.subtree_root at width 1)."""
    words = sha256.bytes_to_words(data)
    n = words.shape[0]
    if n == 0 or n & (n - 1):
        raise ValueError(f"chunk count {n} is not a power of two")
    level = sha256.words_from_numpy(words, _require_device(device))
    root = merkle_tree_root_cuda(level, n.bit_length() - 1)
    return sha256.words_to_bytes(root[None])
