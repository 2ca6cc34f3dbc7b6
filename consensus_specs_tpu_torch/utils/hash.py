"""The consensus hash function (SHA-256), matching the reference surface
(consensus-specs tests/core/pyspec/eth2spec/utils/hash_function.py).
"""
import hashlib

from ..ssz.types import Bytes32


def hash(data: bytes) -> Bytes32:  # noqa: A001 - spec name
    return Bytes32(hashlib.sha256(data).digest())
