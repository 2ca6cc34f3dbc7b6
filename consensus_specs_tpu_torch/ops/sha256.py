"""Batched SHA-256 in plain PyTorch: the plain version of the CUDA kernel.

Counterpart of consensus_specs_tpu/ops/sha256.py (the XLA twin of the TPU
kernel).  The same functions over the same layout: a chunk is 8 big-endian
32-bit words, a 64-byte message 16 words, and every 2-to-1 hash is exactly two
compressions (message block, then the shared pad block).

Words travel in int32 tensors holding the uint32 bit patterns, because torch
on the CPU has no uint32 add, shift or `~`.  The arithmetic runs in int64
masked to 32 bits: values stay in [0, 2**32), so `>>` is a logical shift and
`~e` is written `e ^ 0xFFFFFFFF`.

This module is the step-by-step reference the kernels are held against
(chip_smoke.py on the card) and what a CPU tensor gets from the kernels'
wrappers (ops/sha256_cuda.py).  It runs on whatever device its tensors lie
on.

It also holds `fused_rounds`, the fused multi-round sweep of an incremental
re-root (ssz/incremental.py), with the reference's name, signature and
device literal pool: on the card each round is one launch of the
gather-hash kernel; on the CPU each round is `hash_gather_pairs`.
"""
from __future__ import annotations

import threading

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


def hash_gather_pairs(pool: torch.Tensor, idx_l: torch.Tensor,
                      idx_r: torch.Tensor) -> torch.Tensor:
    """Hash of pairs gathered by index: int32[P, 8], int32[n], int32[n] ->
    int32[n, 8], row k the hash of pool[idx_l[k]] || pool[idx_r[k]]."""
    left = pool[idx_l.long()]
    right = pool[idx_r.long()]
    return hash_pairs(torch.stack([left, right], dim=1).reshape(-1, 8))


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


# ---------------------------------------------------------------------------
# fused multi-round sweep (device-resident incremental merkle re-root)
# ---------------------------------------------------------------------------
# The reference (consensus_specs_tpu/ops/sha256.py) runs a sweep as one XLA
# program over power-of-two padded shapes.  Here a sweep is one buffer,
# int32[pool_rows + sum of round sizes, 8]: the pool's rows, then every
# round's outputs at unpadded offsets.  Round r is one gather-hash launch
# that reads rows below its offset and writes its digests at it.
#
# Between consecutive sweeps most literal inputs repeat (the clean cached
# siblings along every dirty path, the zero-hash ladder, the parents the
# previous sweep computed), so a content-addressed pool keeps them on the
# device, exactly as in the reference: `_LIT_INDEX` maps a chunk's 32 bytes
# to its pool row, capacity is `_POOL_CAP` rows, an overflow drops the pool,
# and a sweep with more literals than the pool bypasses it.  The pool's rows
# live at the head of the previous sweep's buffer (`_LIT_POOL`, its first
# `_LIT_ROWS` rows); the outputs that sweep adopted into the pool are rows of
# that buffer too (`_ADOPT`), and the next sweep copies them behind the head
# on the device.  So a sweep makes one host->device upload (the adopted row
# numbers, the fresh literals and every round's indices, in one int32
# array) and one device->host download (every round's outputs).

_POOL_CAP = 1 << 15         # 32k chunks = 1 MiB of device residency
_LIT_POOL = None            # the last pooled sweep's buffer, int32[rows, 8]
_LIT_ROWS = 0               # pool rows at the head of _LIT_POOL
_ADOPT = np.zeros(0, dtype=np.int64)  # _LIT_POOL rows adopted after the head
_LIT_INDEX: dict = {}       # chunk bytes -> pool row
_LIT_USED = 0               # pool rows: _LIT_ROWS + len(_ADOPT) + fresh
_POOL_DEVICE = None
_POOL_LOCK = threading.Lock()


def _reset_pool_unlocked() -> None:
    global _LIT_POOL, _LIT_ROWS, _ADOPT, _LIT_INDEX, _LIT_USED
    _LIT_POOL = None
    _LIT_ROWS = 0
    _ADOPT = np.zeros(0, dtype=np.int64)
    _LIT_INDEX = {}
    _LIT_USED = 0


def reset_literal_pool() -> None:
    """Drop the device literal pool (device change, tests)."""
    with _POOL_LOCK:
        _reset_pool_unlocked()


def _adopt_outputs(out_bytes: list, out_row: list) -> np.ndarray:
    """Enter each round's new output chunks into the pool index, as the
    reference's _pool_adopt_outputs does (deduped within the round, no
    adoption past the capacity).  Returns their rows in the sweep's buffer,
    which the next sweep copies behind the pool's head."""
    global _LIT_USED
    adopt = []
    for blist, first in zip(out_bytes, out_row):
        fresh = []
        seen = set()
        for k, b in enumerate(blist):
            if b not in _LIT_INDEX and b not in seen:
                seen.add(b)
                fresh.append((k, b))
        if not fresh:
            continue
        if _LIT_USED + len(fresh) > _POOL_CAP:
            break                       # bounded residency: stop adopting
        for k, b in fresh:
            adopt.append(first + k)
            _LIT_INDEX[b] = _LIT_USED
            _LIT_USED += 1
    return np.asarray(adopt, dtype=np.int64)


def fused_rounds(literals: bytes, rounds, stats: dict | None = None) -> list:
    """Device-resident execution of a whole hash-job DAG
    (ssz/incremental.py `_Sweep`): `literals` is the concatenation of
    every distinct 32-byte input chunk, `rounds` is a list of
    (left_idx, right_idx) int lists indexing the virtual unpadded pool
    [literals..., round0 outputs..., round1 outputs...]: every index
    must refer to a literal or an earlier round's output (ValueError
    otherwise).  Returns one bytes object per round (that round's
    concatenated 32-byte digests).

    Runs on the port's device (`consensus_specs_tpu_torch.get_device()`):
    one gather-hash kernel launch a round on the card, `hash_gather_pairs`
    on the CPU.  One host->device upload (only the literals the pool has
    not seen), one device->host download.  `stats`, when given, is filled
    with {"uploaded": fresh literals uploaded, "skipped": pool hits that
    skipped a re-upload}, as in the reference."""
    global _LIT_POOL, _LIT_ROWS, _ADOPT, _LIT_USED, _POOL_DEVICE
    if not rounds:
        return []
    from .. import get_device
    from .cuda_build import require_device
    from .sha256_cuda import hash_gather_pairs_cuda
    device = require_device(get_device())
    n_lits = len(literals) // 32
    sizes = [len(il) for il, _ir in rounds]
    if any(len(ir) != n for (_il, ir), n in zip(rounds, sizes)):
        raise ValueError("a round's left and right index counts differ")
    cum = np.cumsum([0] + sizes)
    total = int(cum[-1])
    idx_l = np.fromiter((i for il, _ir in rounds for i in il), np.int64, total)
    idx_r = np.fromiter((i for _il, ir in rounds for i in ir), np.int64, total)
    for r, (lo, hi) in enumerate(zip(cum[:-1], cum[1:])):
        seg = np.concatenate([idx_l[lo:hi], idx_r[lo:hi]])
        if seg.size and (seg.min() < 0 or seg.max() >= n_lits + lo):
            raise ValueError(f"round {r} reads a row that is neither a "
                             f"literal nor an earlier round's output")
    pooled = n_lits <= _POOL_CAP
    with _POOL_LOCK:
        if _POOL_DEVICE != device:
            _reset_pool_unlocked()
            _POOL_DEVICE = device
        if pooled:
            chunks = [literals[k * 32:(k + 1) * 32] for k in range(n_lits)]
            fresh = []
            seen_fresh = set()
            for c in chunks:
                if c not in _LIT_INDEX and c not in seen_fresh:
                    seen_fresh.add(c)
                    fresh.append(c)
            skipped = n_lits - len(fresh)
            if _LIT_USED + len(fresh) > _POOL_CAP:
                _reset_pool_unlocked()      # overflow: drop and re-seed
                fresh = list(dict.fromkeys(chunks))
                skipped = 0
            head, head_rows, adopt = _LIT_POOL, _LIT_ROWS, _ADOPT
            fresh_row = _LIT_USED
            for c in fresh:
                _LIT_INDEX[c] = _LIT_USED
                _LIT_USED += 1
            pool_rows = _LIT_USED
            row_map = np.fromiter((_LIT_INDEX[c] for c in chunks), np.int64,
                                  n_lits)
            n_fresh = len(fresh)
            fresh_words = bytes_to_words(b"".join(fresh))
        else:
            # a sweep larger than the pool bypasses residency entirely
            _reset_pool_unlocked()
            skipped = 0
            n_fresh = n_lits
            head, head_rows, adopt = None, 0, np.zeros(0, dtype=np.int64)
            fresh_row = 0
            pool_rows = n_lits
            row_map = np.arange(n_lits, dtype=np.int64)
            fresh_words = bytes_to_words(literals)
        if stats is not None:
            stats["uploaded"] = n_fresh
            stats["skipped"] = skipped

        def remap(idx):
            out = idx - n_lits + pool_rows
            lit = idx < n_lits
            out[lit] = row_map[idx[lit]]
            return out

        # the one upload: adopted rows, fresh literal words, indices
        host = np.concatenate([
            adopt.astype(np.int32), fresh_words.view(np.int32).reshape(-1),
            remap(idx_l).astype(np.int32), remap(idx_r).astype(np.int32)])
        upload = torch.from_numpy(host).to(device)
        n_adopt, n_words = len(adopt), fresh_words.size
        dev_l = upload[n_adopt + n_words:n_adopt + n_words + total]
        dev_r = upload[n_adopt + n_words + total:]
        buf = torch.empty((pool_rows + total, 8), dtype=torch.int32,
                          device=device)
        if head_rows:
            buf[:head_rows] = head[:head_rows]
        if n_adopt:
            buf[head_rows:head_rows + n_adopt] = head.index_select(
                0, upload[:n_adopt])
        buf[fresh_row:fresh_row + n_fresh] = \
            upload[n_adopt:n_adopt + n_words].view(-1, 8)
        for lo, hi in zip(cum[:-1], cum[1:]):
            hash_gather_pairs_cuda(buf, dev_l[lo:hi], dev_r[lo:hi],
                                   pool_rows + int(lo))
        # the one download: every round's outputs
        out = words_to_bytes(buf[pool_rows:])
        out_bytes = [out[32 * lo:32 * hi] for lo, hi in zip(cum[:-1], cum[1:])]
        if pooled:
            _ADOPT = _adopt_outputs(
                [[ob[k * 32:(k + 1) * 32] for k in range(s)]
                 for ob, s in zip(out_bytes, sizes)],
                [pool_rows + int(lo) for lo in cum[:-1]])
            _LIT_POOL, _LIT_ROWS = buf, pool_rows
    return out_bytes
