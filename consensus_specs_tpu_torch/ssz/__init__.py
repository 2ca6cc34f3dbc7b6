"""SSZ engine: type system, serialization, merkleization.

Counterpart of consensus_specs_tpu/ssz: the spec-facing surface of the
consensus-specs eth2spec.utils.ssz.{ssz_typing,ssz_impl} (types.py /
merkle.py / impl.py).  Incremental merkleization is not ported yet.
"""
from .types import (  # noqa: F401
    SSZType, uint, uint8, uint16, uint32, uint64, uint128, uint256,
    boolean, bit, byte, Bitvector, Bitlist, ByteVector, ByteList,
    Vector, List, Container, Union,
    Bytes1, Bytes4, Bytes8, Bytes20, Bytes31, Bytes32, Bytes48, Bytes96,
)
from .impl import (  # noqa: F401
    serialize, hash_tree_root, uint_to_bytes, copy,
)
from .merkle import (  # noqa: F401
    merkleize_chunks, mix_in_length, get_merkle_proof, is_valid_merkle_branch,
    ZERO_HASHES, use_device_hashing, use_host_hashing,
)
