"""State, words and sweep inputs carried across from the JAX package.

The port shares no object with the reference.  A `BeaconState` crosses as
its SSZ encoding (`state.encode_bytes()` on the reference side), chunk words
as uint32 numpy arrays, and an epoch sweep's inputs as numpy columns and
plain values (`sweep_inputs_from_numpy`).
"""
from __future__ import annotations

import numpy as np

from .ops.sha256 import words_from_numpy, words_to_numpy  # noqa: F401


def state_from_ssz(spec, data: bytes):
    """Decode an SSZ-encoded BeaconState into `spec`'s own container."""
    return spec.BeaconState.decode_bytes(data)


def sweep_inputs_from_numpy(family, n, cols, scalars, statics):
    """The port's `SweepInputs` from a reference SweepInputs taken apart:
    its family, lane count, numpy columns, scalars (numpy or plain
    integers) and statics (name, value) pairs.  Columns are copied, so the
    two bundles share no array; scalars become ints."""
    from .specs.epoch_fast import SweepInputs
    return SweepInputs(
        str(family), int(n),
        {k: np.array(v, copy=True) for k, v in cols.items()},
        {k: int(v) for k, v in scalars.items()},
        tuple(sorted((str(k), v) for k, v in dict(statics).items())))
