"""The CUDA SHA-256 pair-hash kernel: build, launch and count.

Counterpart of consensus_specs_tpu/ops/sha256_pallas.py.  The kernel
(csrc/sha256_pairs.cu, written for sm_90a) computes what the Pallas kernel
computes, the 2-to-1 hash of chunk pairs, int32[2N, 8] -> int32[N, 8] (uint32
bit patterns), with no padding of N.

The kernel is built from the package's own sources at first use, into
`build/torch_ext/` beside the package: with `torch.utils.cpp_extension.load`
where `ninja` is installed, else with `nvcc -shared` into a plain C library
loaded with ctypes.  Nothing is built while this module is imported.

`hash_pairs_cuda` is the one wrapper.  On a CUDA tensor it launches the kernel
or raises; on a CPU tensor it runs the plain version (ops/sha256.py), and only
for that reason.  `hash_pairs_cuda.launches` counts kernel launches and
`hash_pairs_cuda.plain_calls` counts calls that took the plain version.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import torch

from . import sha256

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
KERNEL_SOURCE = os.path.join(_CSRC, "sha256_pairs.cu")
BINDING_SOURCE = os.path.join(_CSRC, "sha256_pairs_bind.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "torch_ext")
ARCH_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

_launch = None      # (chunks, out) -> None, once built
build_route = None  # "cpp_extension" or "ctypes", once built


def _build_cpp_extension():
    from torch.utils import cpp_extension
    ext = cpp_extension.load(
        name="sha256_pairs_ext",
        sources=[KERNEL_SOURCE, BINDING_SOURCE],
        build_directory=BUILD_DIR,
        extra_cuda_cflags=ARCH_FLAGS,
        verbose=False)
    return ext.sha256_pairs


def _build_ctypes():
    from torch.utils import cpp_extension
    lib_path = os.path.join(BUILD_DIR, "libsha256_pairs.so")
    nvcc = os.path.join(cpp_extension.CUDA_HOME or "/usr/local/cuda",
                        "bin", "nvcc")
    r = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
         "-o", lib_path, KERNEL_SOURCE],
        capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    fn = ctypes.CDLL(lib_path).sha256_pairs_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(chunks, out):
        stream = torch.cuda.current_stream(chunks.device).cuda_stream
        rc = fn(chunks.data_ptr(), out.data_ptr(), out.shape[0], stream)
        if rc != 0:
            raise RuntimeError(f"sha256_pairs launch failed: CUDA error {rc}")
    return launch


def build():
    """Build the kernel (once per process) and return its launcher."""
    global _launch, build_route
    if _launch is None:
        from torch.utils import cpp_extension
        os.makedirs(BUILD_DIR, exist_ok=True)
        if cpp_extension.is_ninja_available():
            _launch, build_route = _build_cpp_extension(), "cpp_extension"
        else:
            _launch, build_route = _build_ctypes(), "ctypes"
    return _launch


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
    launch = build()
    out = torch.empty((chunks.shape[0] // 2, 8), dtype=torch.int32,
                      device=chunks.device)
    if out.shape[0]:
        launch(chunks, out)
        hash_pairs_cuda.launches += 1
    return out


hash_pairs_cuda.launches = 0
hash_pairs_cuda.plain_calls = 0


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
