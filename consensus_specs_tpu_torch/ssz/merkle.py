"""Binary SHA-256 merkleization over 32-byte chunks.

Counterpart of consensus_specs_tpu/ssz/merkle.py: the same flat chunk-array
level loop, zero-hash table, bulk threshold (2048 pairs) and subtree rule.
What differs:

- The device hashers are installed by default and run on the port's device
  (`consensus_specs_tpu_torch.get_device()`, the CUDA card unless the caller
  chose the CPU).  Levels of at least `_bulk_threshold` pairs go through the
  CUDA SHA-256 kernel one level at a time (ops.sha256_cuda.hash_level_cuda);
  near-full populated subtrees of at least `_subtree_threshold` chunks are
  uploaded once and hashed level by level on the card
  (ops.sha256_cuda.merkle_root_cuda, the JAX package's
  parallel/mesh_engine.subtree_root at width 1).
- There is no resilience supervisor and no hashlib fallback around the
  device hashers: a build or launch failure on the card raises.
- Levels below the bulk threshold stay on hashlib, as in the JAX package:
  that is its design for small containers, not a fallback.

`use_host_hashing()` uninstalls both device hashers; it is the plain
reference a device run is checked against.  `stats` counts the pairs each
side hashed.
"""
from __future__ import annotations

import hashlib
from typing import Sequence

from .. import get_device
from ..ops.sha256_cuda import hash_level_cuda, merkle_root_cuda

ZERO_CHUNK = b"\x00" * 32
MAX_DEPTH = 64

#: pairs hashed on the port's device and with hashlib, since reset_stats()
stats = {"device_pairs": 0, "host_pairs": 0}


def reset_stats() -> None:
    stats["device_pairs"] = 0
    stats["host_pairs"] = 0


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def hash_pair(left: bytes, right: bytes) -> bytes:
    stats["host_pairs"] += 1
    return hashlib.sha256(left + right).digest()


def _build_zero_hashes() -> list[bytes]:
    zh = [ZERO_CHUNK]
    for _ in range(MAX_DEPTH):
        zh.append(hashlib.sha256(zh[-1] + zh[-1]).digest())
    return zh


#: ZERO_HASHES[i] = root of a fully-zero subtree of depth i
ZERO_HASHES: list[bytes] = _build_zero_hashes()


def next_power_of_two(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def chunk_depth(chunk_count: int) -> int:
    """Depth of the padded tree for `chunk_count` leaves."""
    return max(0, (next_power_of_two(chunk_count) - 1).bit_length())


def _hash_level(data: bytes) -> bytes:
    """hashlib level hasher: 2N concatenated chunks -> N parents."""
    stats["host_pairs"] += len(data) // 64
    out = bytearray()
    h = hashlib.sha256
    for i in range(0, len(data), 64):
        out += h(data[i:i + 64]).digest()
    return bytes(out)


def device_hash_level(data: bytes) -> bytes:
    stats["device_pairs"] += len(data) // 64
    return hash_level_cuda(data, get_device())


def device_subtree_root(level: bytes, depth: int) -> bytes:
    stats["device_pairs"] += (1 << depth) - 1
    return merkle_root_cuda(level, get_device())


# Bulk hasher: used instead of _hash_level for levels of >= _bulk_threshold
# pairs, where the device batch amortizes the host<->device transfer.
_bulk_hash_level = device_hash_level
_bulk_threshold = 2048

# Whole-subtree hasher: collapses the level loop for large populated
# subtrees into one call.  `fn(level_bytes, depth)` gets a power-of-two
# chunk concatenation and returns the 32-byte subtree root.
_subtree_hasher = device_subtree_root
_subtree_threshold = 1 << 14


def set_bulk_level_hasher(fn, threshold: int = 2048) -> None:
    """Install a large-level hasher: `fn` receives the concatenation of 2N
    chunks (N >= threshold) and returns the N parents.  None uninstalls."""
    global _bulk_hash_level, _bulk_threshold
    _bulk_hash_level = fn
    _bulk_threshold = threshold


def set_subtree_hasher(fn, threshold: int = 1 << 14) -> None:
    global _subtree_hasher, _subtree_threshold
    _subtree_hasher = fn
    _subtree_threshold = threshold


def use_device_hashing(threshold: int = 2048,
                       subtree_threshold: int = 1 << 14) -> None:
    """Route big levels and near-full populated subtrees to the port's
    device (the default; counterpart of the JAX package's
    use_tpu_hashing(pallas=True) plus mesh_engine's subtree hook)."""
    set_bulk_level_hasher(device_hash_level, threshold)
    set_subtree_hasher(device_subtree_root, subtree_threshold)


def use_host_hashing() -> None:
    """Hash every level with hashlib: the plain reference for a device run."""
    set_bulk_level_hasher(None)
    set_subtree_hasher(None)


def merkleize_chunks(chunks: Sequence[bytes], limit: int | None = None) -> bytes:
    """Merkle root of `chunks`, virtually padded with zero chunks.

    `limit` is the maximum number of leaves the tree is sized for (list
    merkleization); None means pad to the next power of two of len(chunks)
    (vector merkleization).  Only the populated subtree is hashed; zero
    subtrees come from the precomputed ZERO_HASHES table.
    """
    count = len(chunks)
    if limit is not None:
        if count > limit:
            raise ValueError(f"chunk count {count} exceeds limit {limit}")
        depth = chunk_depth(limit)
    else:
        depth = chunk_depth(count)

    if count == 0:
        return ZERO_HASHES[depth]

    level = b"".join(chunks)

    padded = next_power_of_two(count)
    if (_subtree_hasher is not None and count >= _subtree_threshold
            and (padded - count) * 8 <= count):
        # hash the whole populated subtree in one call, then climb the
        # virtually-padded top with zero-tree siblings.  Only near-full
        # trees (< 12.5% zero padding) take this path — a barely-past-a-
        # power-of-two count would nearly double the hash work vs the level
        # loop's ZERO_HASHES shortcuts
        sub_depth = chunk_depth(count)
        if padded != count:
            level += bytes(32) * (padded - count)
        root = _subtree_hasher(level, sub_depth)
        for d in range(sub_depth, depth):
            root = hash_pair(root, ZERO_HASHES[d])
        return root

    for d in range(depth):
        n = len(level) // 32
        if n % 2 == 1:
            level += ZERO_HASHES[d]
            n += 1
        if _bulk_hash_level is not None and n // 2 >= _bulk_threshold:
            level = _bulk_hash_level(level)
        else:
            level = _hash_level(level)
    assert len(level) == 32
    return level


def mix_in_length(root: bytes, length: int) -> bytes:
    return hash_pair(root, length.to_bytes(32, "little"))


def mix_in_selector(root: bytes, selector: int) -> bytes:
    return hash_pair(root, selector.to_bytes(32, "little"))


def get_merkle_proof(chunks: Sequence[bytes], index: int,
                     limit: int | None = None) -> list[bytes]:
    """Merkle branch for leaf `index` in the (virtually padded) tree
    (consensus-specs merkle_minimal.get_merkle_proof)."""
    count = len(chunks)
    depth = chunk_depth(limit if limit is not None else count)
    proof = []
    level_chunks = list(chunks)
    idx = index
    for d in range(depth):
        sib = idx ^ 1
        if sib < len(level_chunks):
            proof.append(level_chunks[sib])
        else:
            proof.append(ZERO_HASHES[d])
        # build next level
        nxt = []
        for i in range(0, len(level_chunks), 2):
            left = level_chunks[i]
            right = level_chunks[i + 1] if i + 1 < len(level_chunks) else ZERO_HASHES[d]
            nxt.append(hash_pair(left, right))
        level_chunks = nxt
        idx >>= 1
    return proof


def is_valid_merkle_branch(leaf: bytes, branch: Sequence[bytes], depth: int,
                           index: int, root: bytes) -> bool:
    """Verify a merkle branch (spec: phase0 beacon-chain.md is_valid_merkle_branch)."""
    value = leaf
    for i in range(depth):
        if (index >> i) & 1:
            value = hash_pair(branch[i], value)
        else:
            value = hash_pair(value, branch[i])
    return value == root
