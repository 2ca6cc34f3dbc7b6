"""State, words, sweep inputs and field limbs carried across from the JAX
package.

The port shares no object with the reference.  A `BeaconState` or a block
crosses as its SSZ encoding (`encode_bytes()` on the reference side), keys
and signatures as compressed point bytes, chunk words as uint32 numpy
arrays, an epoch sweep's inputs as numpy columns and plain values
(`sweep_inputs_from_numpy`), and BLS12-381 limbs as the reference's uint32
numpy arrays (`fq_limbs_from_numpy`, `fq2_limbs_from_numpy`).
"""
from __future__ import annotations

import numpy as np
import torch

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


def fq_limbs_from_numpy(arr) -> torch.Tensor:
    """The reference's Fq limbs (uint32 numpy [..., 32], 12 bits a limb)
    as the port's int64 limb tensor (the same integers, copied)."""
    arr = np.asarray(arr)
    if arr.shape[-1:] != (32,):
        raise ValueError(f"expected [..., 32] limbs, got {arr.shape}")
    return torch.from_numpy(arr.astype(np.int64))


def fq2_limbs_from_numpy(arr) -> torch.Tensor:
    """The reference's Fq2 limbs (uint32 numpy [..., 2, 32]) as the port's
    int64 limb tensor."""
    arr = np.asarray(arr)
    if arr.shape[-2:] != (2, 32):
        raise ValueError(f"expected [..., 2, 32] limbs, got {arr.shape}")
    return torch.from_numpy(arr.astype(np.int64))
