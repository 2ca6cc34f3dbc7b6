"""Device scalar multiplications of the signature flush.

Counterpart of consensus_specs_tpu/ops/msm.py, the two functions the
signature pipeline calls:

- `g1_weighted_sweep(points, scalars)`: the per-pair weighted points
  [s_i P_i], no reduction: the Fiat-Shamir weighting of a flush's
  aggregates (sigpipe/scheduler.py), one G1 ladder launch
  (ops/csrc/bls381_msm.cu, K2) over 64-bit bit rows when every scalar fits
  in 64 bits, 256-bit rows otherwise;
- `g2_multi_exp(points, scalars)`: sum_i s_i P_i over G2, the folded
  signature sum of a staged flush (sigpipe/fold.py): the G2 ladder
  (ops/csrc/bls381_g2.cu) over the same bit rows, then one segment sum
  (ops/csrc/bls381_msm.cu, K1) over the ladder's outputs, in the
  reference's halving order.

Both run on the device of `consensus_specs_tpu_torch.get_device()`, the
kernels on the card and their plain versions on the CPU; scalars are
reduced mod r first (every input point lies in the r-torsion subgroup).
The reference's windowed Pippenger G1 MSM (`g1_multi_exp`) is not ported
yet (ROADMAP A9), nor its mesh sharding of the ladder axis.
"""
from __future__ import annotations

from ..crypto import curve as cv
from ..crypto.fields import R
from . import bls381_cuda, curve_torch
from .g1_sweep import _device, _pow2


def _scalar_bits(scalars, device):
    """msb-first bit rows [n, 64] of the scalars when all fit in 64 bits,
    else [n, 256] (the reference's `n_bits` choice), uint8 on `device`."""
    width = max((s.bit_length() for s in scalars), default=1) or 1
    return curve_torch.scalars_to_bits(scalars, 64 if width <= 64 else 256,
                                       device)


def g1_weighted_sweep(points, scalars):
    """Per-pair weighted points [s_i * P_i] (oracle G1 Points), one
    ladder launch for the whole list."""
    if len(points) != len(scalars):
        raise ValueError("g1_weighted_sweep: length mismatch")
    if not points:
        return []
    device = _device()
    prods = bls381_cuda.g1_ladder(
        curve_torch.g1_pack(points, device),
        _scalar_bits([int(s) % R for s in scalars], device))
    return curve_torch.g1_unpack(tuple(c.cpu() for c in prods))


def g2_multi_exp(points, scalars):
    """sum_i scalars[i] * points[i] over G2; returns an oracle Point.  The
    ladder axis is padded to a power of two with infinity and scalar 0,
    as in the reference, for the halving sum."""
    if len(points) != len(scalars):
        raise ValueError("g2_multi_exp: length mismatch")
    if not points:
        return cv.g2_infinity()
    n = len(points)
    m = _pow2(n)
    pts = list(points) + [cv.g2_infinity()] * (m - n)
    sc = [int(s) % R for s in scalars] + [0] * (m - n)
    device = _device()
    prods = curve_torch.g2_scalar_mul(curve_torch.g2_pack(pts, device),
                                      _scalar_bits(sc, device))
    total = bls381_cuda.segment_sum(tuple(c[None] for c in prods))
    return curve_torch.g2_unpack(tuple(c.cpu() for c in total))[0]
