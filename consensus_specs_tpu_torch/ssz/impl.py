"""Free-function SSZ API, mirroring the consensus-specs ssz_impl surface
(tests/core/pyspec/eth2spec/utils/ssz/ssz_impl.py): serialize /
hash_tree_root / uint_to_bytes / copy.  Counterpart of
consensus_specs_tpu/ssz/impl.py without its whole-tree backend switch: in
the port, large levels always go to the device hashers of ssz/merkle.py.
"""
from __future__ import annotations

from .types import SSZType, uint


def serialize(obj: SSZType) -> bytes:
    return obj.serialize()


def hash_tree_root(obj) -> bytes:
    from .types import Bytes32
    return Bytes32(obj.hash_tree_root())


def uint_to_bytes(n: uint) -> bytes:
    return serialize(n)


def copy(obj: SSZType):
    return obj.copy()
