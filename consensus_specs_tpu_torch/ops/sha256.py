"""Batched SHA-256 in plain PyTorch: the plain version of the CUDA kernel.

Counterpart of consensus_specs_tpu/ops/sha256.py (the XLA twin of the TPU
kernel).  The same functions over the same layout: a chunk is 8 big-endian
32-bit words, a 64-byte message 16 words, and every 2-to-1 hash is exactly two
compressions (message block, then the shared pad block).

Words travel in int32 tensors holding the uint32 bit patterns, because torch
on the CPU has no uint32 add, shift or `~`.  The arithmetic runs in int64
masked to 32 bits: values stay in [0, 2**32), so `>>` is a logical shift and
`~e` is written `e ^ 0xFFFFFFFF`.

This module is the step-by-step reference the kernel is held against
(chip_smoke.py on the card) and what a CPU tensor gets from the kernel's
wrapper (ops/sha256_cuda.py).  It runs on whatever device its tensors lie on.
"""
from __future__ import annotations

import numpy as np
import torch

# round constants (FIPS 180-4)
_K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
)

_IV = (
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
)

# the constant padding block for a 64-byte message: 0x80, zeros, bitlen=512
_PAD_BLOCK = (0x80000000,) + (0,) * 14 + (512,)

_M32 = 0xFFFFFFFF


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & _M32


def _to_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    return words.to(torch.int64) & _M32


def _to_i32(values: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same bit pattern."""
    return ((values ^ 0x80000000) - 0x80000000).to(torch.int32)


def _compress(state: list, w: list) -> list:
    """One compression over int64 columns: 8 state words, 16 message words.
    Returns the 8 new state words (feed-forward added)."""
    a, b, c, d, e, f, g, h = state
    w = list(w)
    for t in range(64):
        if t >= 16:
            s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
            s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ _M32) & g)
        t1 = h + s1 + ch + _K[t] + w[t]
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = s0 + maj
        a, b, c, d, e, f, g, h = ((t1 + t2) & _M32, a, b, c,
                                  (d + t1) & _M32, e, f, g)
    return [(x + s) & _M32 for x, s in zip((a, b, c, d, e, f, g, h), state)]


def _columns(words: torch.Tensor) -> list:
    u = _to_u32(words)
    return [u[..., i] for i in range(u.shape[-1])]


def _constant_columns(values, like: torch.Tensor) -> list:
    return [torch.full(like.shape[:-1], v, dtype=torch.int64,
                       device=like.device) for v in values]


def sha256_compress(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One SHA-256 compression: state int32[..., 8], block int32[..., 16]
    (uint32 bit patterns).  Returns int32[..., 8]."""
    out = _compress(_columns(state), _columns(block))
    return _to_i32(torch.stack(out, dim=-1))


def sha256_64byte(blocks: torch.Tensor) -> torch.Tensor:
    """Digest of a batch of 64-byte messages: int32[N, 16] -> int32[N, 8]."""
    mid = _compress(_constant_columns(_IV, blocks), _columns(blocks))
    out = _compress(mid, _constant_columns(_PAD_BLOCK, blocks))
    return _to_i32(torch.stack(out, dim=-1))


def hash_pairs(chunks: torch.Tensor) -> torch.Tensor:
    """2-to-1 hash of adjacent chunk pairs: int32[2N, 8] -> int32[N, 8].
    No padding: the batch is exactly the N pairs given."""
    return sha256_64byte(chunks.reshape(-1, 16))


def merkle_tree_root(chunks: torch.Tensor, depth: int) -> torch.Tensor:
    """Root of a balanced tree over int32[2**depth, 8] chunks: int32[8]."""
    level = chunks
    for _ in range(depth):
        level = hash_pairs(level)
    return level[0]


# ---------------------------------------------------------------------------
# host-side bridges
# ---------------------------------------------------------------------------

def bytes_to_words(data: bytes) -> np.ndarray:
    """32-byte chunks (concatenated) -> uint32[N, 8] big-endian words."""
    return np.frombuffer(data, dtype=">u4").reshape(-1, 8).astype(np.uint32)


def words_to_bytes(words) -> bytes:
    """uint32[N, 8] words (numpy, or an int32 tensor) -> concatenated chunks."""
    if isinstance(words, torch.Tensor):
        words = words_to_numpy(words)
    return np.asarray(words).astype(">u4").tobytes()


def words_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor with the same bit patterns."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))
    return t if device is None else t.to(device)


def words_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor of word bit patterns -> uint32 numpy words."""
    return t.detach().cpu().numpy().view(np.uint32)


def hash_level(data: bytes, device="cpu") -> bytes:
    """Hash the concatenation of 2N chunks into N parent chunks."""
    return words_to_bytes(hash_pairs(words_from_numpy(bytes_to_words(data),
                                                      device)))


def merkle_root(data: bytes, device="cpu") -> bytes:
    """Merkle root of a power-of-two chunk array."""
    words = bytes_to_words(data)
    n = words.shape[0]
    if n == 0 or n & (n - 1):
        raise ValueError(f"chunk count {n} is not a power of two")
    root = merkle_tree_root(words_from_numpy(words, device), n.bit_length() - 1)
    return words_to_bytes(root[None])
