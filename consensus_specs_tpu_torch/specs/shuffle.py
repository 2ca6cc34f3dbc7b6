"""Vectorized swap-or-not shuffle: the full permutation in one sweep.

A copy of `shuffle_permutation` from consensus_specs_tpu/specs/shuffle.py
(numpy and hashlib only; the port imports nothing of the reference).  The
spec's per-index `compute_shuffled_index` (specs/phase0/beacon-chain.md
"compute_shuffled_index") costs SHUFFLE_ROUND_COUNT rounds x 2 SHA-256 per
index; the whole permutation at once costs rounds x (ceil(n/256) + 1)
hashes in all: every index of a 256-position block shares one `source`
digest, and the swap decisions become numpy mask ops over the index axis.

`proposer_candidate_tables` comes with the block slice of the port.
"""
from __future__ import annotations

import hashlib

import numpy as np


def shuffle_permutation(seed: bytes, n: int, rounds: int) -> np.ndarray:
    """perm with perm[i] == compute_shuffled_index(i, n, seed), vectorized.

    Returns an int64 array of length n.
    """
    if n <= 1:
        return np.arange(max(n, 0), dtype=np.int64)
    idx = np.arange(n, dtype=np.int64)
    n_blocks = (n + 255) // 256
    sha = hashlib.sha256
    for r in range(rounds):
        rb = bytes([r])
        pivot = int.from_bytes(sha(seed + rb).digest()[:8], "little") % n
        flip = (pivot - idx) % n
        pos = np.maximum(idx, flip)
        src = np.frombuffer(
            b"".join(sha(seed + rb + b.to_bytes(4, "little")).digest()
                     for b in range(n_blocks)),
            dtype=np.uint8).reshape(n_blocks, 32)
        byte_val = src[pos >> 8, (pos & 0xFF) >> 3]
        bit = (byte_val >> (pos & 0x07).astype(np.uint8)) & 1
        idx = np.where(bit == 1, flip, idx)
    return idx
