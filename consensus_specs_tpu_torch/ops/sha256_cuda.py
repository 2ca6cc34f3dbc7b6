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

Both are built at first use with the port's other kernels (ops/cuda_build.py).

`hash_pairs_cuda` and `hash_gather_pairs_cuda` are the wrappers.  On CUDA
tensors each launches its kernel or raises; on CPU tensors it runs the plain
version (ops/sha256.py), and only for that reason.  Each wrapper's
`.launches` counts kernel launches and `.plain_calls` counts calls that took
the plain version.
"""
from __future__ import annotations

import os

import torch

from . import cuda_build, sha256

CORE_SOURCE = os.path.join(cuda_build.CSRC, "sha256_core.cuh")


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
    kernels = cuda_build.build()
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
    kernels = cuda_build.build()
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
                                    cuda_build.require_device(device))
    return sha256.words_to_bytes(hash_pairs_cuda(words))


def merkle_root_cuda(data: bytes, device) -> bytes:
    """Subtree hasher for ssz.merkle: root of a power-of-two chunk array.
    Uploads the level once, hashes every level on `device` and downloads
    the 32-byte root (mesh_engine.subtree_root at width 1)."""
    words = sha256.bytes_to_words(data)
    n = words.shape[0]
    if n == 0 or n & (n - 1):
        raise ValueError(f"chunk count {n} is not a power of two")
    level = sha256.words_from_numpy(words, cuda_build.require_device(device))
    root = merkle_tree_root_cuda(level, n.bit_length() - 1)
    return sha256.words_to_bytes(root[None])
