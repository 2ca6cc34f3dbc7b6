"""State and words carried across from the JAX package, as bytes.

The port shares no object with the reference.  A `BeaconState` crosses as
its SSZ encoding (`state.encode_bytes()` on the reference side), chunk words
as uint32 numpy arrays.
"""
from __future__ import annotations

from .ops.sha256 import words_from_numpy, words_to_numpy  # noqa: F401


def state_from_ssz(spec, data: bytes):
    """Decode an SSZ-encoded BeaconState into `spec`'s own container."""
    return spec.BeaconState.decode_bytes(data)
