"""The verify path's device surface, at mesh width 1.

Counterpart of consensus_specs_tpu/parallel/shard_verify.py.  The reference
partitions the pairing product, the committee sweep and the weighted MSM
over a device mesh; the port has no mesh yet (ROADMAP A10), so `get_mesh()`
is None, `mesh_devices()` 1 and `pairing_live()` False, and `pairing_fold`
is the one-launch folded flush on one card.
"""
from __future__ import annotations

from ..crypto import curve as cv
from ..crypto import hash_to_curve as h2c


def get_mesh():
    """The verify mesh: none at width 1."""
    return None


def mesh_devices() -> int:
    return 1


def pairing_live() -> bool:
    """Whether the fused product rides a sharded seam: never at width 1."""
    return False


def fold_inputs(aggs, coeffs, roots, sigs):
    """The one-launch fold's inputs for N sets, on the device: the host
    hash-to-field, SSWU and isogeny of each root (the split of
    ops/bls_cuda.py `hash_to_g2_batch`), and the sets padded to a power of
    two k with rows that come out skipped (infinity aggregate, coefficient
    0, the first hash point repeated, infinity signature).  Returns
    (aggP, cbits, hP, sP) for `pairing_torch.fold_partial_products`."""
    from ..ops import curve_torch
    from ..ops.g1_sweep import _device, _pow2

    n = len(aggs)
    pre = []
    for root in roots:
        u0, u1 = h2c.hash_to_field_fq2(bytes(root), 2)
        pre.append(h2c.iso_map(*h2c.sswu_map(u0))
                   + h2c.iso_map(*h2c.sswu_map(u1)))
    pad = _pow2(n) - n
    aggs = list(aggs) + [cv.g1_infinity()] * pad
    coeffs = [int(c) for c in coeffs] + [0] * pad
    pre = pre + [pre[0]] * pad
    sigs = list(sigs) + [cv.g2_infinity()] * pad
    device = _device()
    return (curve_torch.g1_pack(aggs, device),
            curve_torch.scalars_to_bits(coeffs, 64, device),
            curve_torch.g2_pack(pre, device),
            curve_torch.g2_pack(sigs, device))


def pairing_fold(aggs, coeffs, roots, sigs) -> bool:
    """The verdict of one folded flush of N sets: its inputs
    (`fold_inputs`), one `pairing_torch.fold_partial_products` over the
    k + 1 pairs and one `fq12_product_is_one`."""
    from ..ops import pairing_torch

    if not aggs:
        return True
    partial = pairing_torch.fold_partial_products(
        *fold_inputs(aggs, coeffs, roots, sigs))
    return pairing_torch.fq12_product_is_one(partial[None])
