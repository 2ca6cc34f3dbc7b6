"""Batched G1 aggregation sweep: many ragged point lists -> one sum each.

Counterpart of consensus_specs_tpu/ops/g1_sweep.py.  The committee pubkey
sums of a signature flush (sigpipe/cache.py) are packed into one padded
ragged-segment tensor, [segments, length] Jacobian limbs with infinity
padding and both axes rounded up to powers of two as in the reference, and
each segment is summed by halving: on the card by the segment-sum kernel
(ops/csrc/bls381_msm.cu, one thread block a segment), on the CPU by its
plain version (bls381_cuda.halving_sum, log2(length) batched
`curve_torch.point_add` calls).  The pair order is the reference's
`_jax_sweep`, so the sums are its Jacobian points.

The reference's engine switch (`G1_SWEEP_MODE`, the `_oracle_sweep` host
engine on CPU hosts) is not mirrored: the device of
`consensus_specs_tpu_torch.get_device()` decides, and the mesh sharding of
the segment axis is not ported (width 1).

Oracle: summing each list with crypto/curve.py `Point.__add__`.
"""
from __future__ import annotations

import consensus_specs_tpu_torch as _port
from ..crypto import curve as cv
from . import bls381_cuda, cuda_build, curve_torch, fq


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


def _device():
    return cuda_build.require_device(_port.get_device())


def g1_add_sweep(point_lists):
    """Sum each list of oracle G1 Points; returns one Point per list
    (infinity for an empty list), all in one segment-sum call."""
    point_lists = [list(pts) for pts in point_lists]
    if not point_lists:
        return []
    n_seg = len(point_lists)
    seg_len = _pow2(max(len(pts) for pts in point_lists) or 1)
    n_pad = _pow2(n_seg)
    inf = cv.g1_infinity()
    flat = []
    for pts in point_lists:
        flat.extend(pts)
        flat.extend([inf] * (seg_len - len(pts)))
    flat.extend([inf] * (seg_len * (n_pad - n_seg)))
    packed = curve_torch.g1_pack(flat, _device())
    sums = bls381_cuda.segment_sum(
        tuple(c.reshape(n_pad, seg_len, fq.LIMBS) for c in packed))
    return curve_torch.g1_unpack(tuple(c[:n_seg].cpu() for c in sums))
