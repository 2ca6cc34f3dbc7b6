"""The port's one-launch fold against the JAX package's pairing oracle.

`ops/pairing_torch.fold_partial_products` (the fold kernel's plain version,
then the Miller loops and their product without the final exponentiation)
gives a folded flush's partial Fq12 product: the k legs
e(c_i agg_i, h_eff Q_i) and the leg e(-g1, S), S = sum_i c_i sig_i.  Its
final exponentiation must equal the JAX package's `crypto.pairing` product
of the same legs, as field elements:

- k = 2: one lane whose aggregate is infinity (skipped) and infinity
  signatures, so S is infinity and the last pair is skipped too;
- k = 4: the shape `parallel/shard_verify.pairing_fold` pads a 3-set flush
  to, its last lane a padding row (infinity aggregate, coefficient 0, the
  first hash point repeated, infinity signature).

Under `slow` the partial product is held limb for limb against the JAX
package's staged `ops/pairing_jax.fold_partial_products` on the CPU.  The
same seeded scalars cross the package line as integers; the hash points
as affine integers.
"""
import numpy as np
import pytest

import consensus_specs_tpu_torch as port
from consensus_specs_tpu.crypto import curve as ref_cv
from consensus_specs_tpu.crypto import hash_to_curve as ref_h2c
from consensus_specs_tpu.crypto import pairing as ref_pairing
from consensus_specs_tpu_torch.crypto import curve as cv
from consensus_specs_tpu_torch.crypto import hash_to_curve as h2c
from consensus_specs_tpu_torch.ops import bls381_cuda, pairing_torch
from consensus_specs_tpu_torch.ops import curve_torch as ct
from consensus_specs_tpu_torch.ops import fq_tower as ft

SEED = 2026


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")


def _case(k, rng):
    """(aggregate scalars or None, coefficients, pre-cofactor hash points as
    affine integers, signature scalars or None) of a k-lane fold."""
    aggs = [int(s) for s in rng.integers(1, 2**62, size=k)]
    sigs = [int(s) for s in rng.integers(1, 2**62, size=k)]
    coeffs = [int(c) for c in rng.integers(1, 2**63, size=k,
                                           dtype=np.uint64)]
    coeffs[0] = 2**64 - 1
    hashes = []
    for i in range(k):
        u0, u1 = h2c.hash_to_field_fq2(bytes([i, k]) * 16, 2)
        q = h2c.iso_map(*h2c.sswu_map(u0)) + h2c.iso_map(*h2c.sswu_map(u1))
        x, y = q.affine()
        hashes.append((x.c0, x.c1, y.c0, y.c1))
    if k == 2:
        aggs[1] = None
        sigs = [None, None]
    else:
        aggs[-1], coeffs[-1], sigs[-1] = None, 0, None
        hashes[-1] = hashes[0]
    return aggs, coeffs, hashes, sigs


def _inputs(module, case):
    """The case as `module`'s (the port's or the reference's) oracle points:
    (aggregates, coefficients, hash points, signatures)."""
    aggs, coeffs, hashes, sigs = case
    g1, g2 = module.g1_generator(), module.g2_generator()
    return ([module.g1_infinity() if a is None else g1 * a for a in aggs],
            coeffs,
            [module.Point(module.Fq2(h[0], h[1]), module.Fq2(h[2], h[3]),
                          module.Fq2(1, 0), module.B2) for h in hashes],
            [module.g2_infinity() if s is None else g2 * s for s in sigs])


def _flat(f):
    """An Fq12 as its twelve coefficient integers."""
    return [c for f6 in (f.c0, f.c1) for f2 in (f6.c0, f6.c1, f6.c2)
            for c in (f2.c0, f2.c1)]


def _port_partial(case):
    aggs, coeffs, hashes, sigs = _inputs(cv, case)
    return pairing_torch.fold_partial_products(
        ct.g1_pack(aggs), ct.scalars_to_bits(coeffs, 64), ct.g2_pack(hashes),
        ct.g2_pack(sigs))


@pytest.mark.parametrize("k", [2, 4])
def test_fold_partial_product_equals_the_oracle(k):
    case = _case(k, np.random.default_rng([SEED, k]))
    before = bls381_cuda.fold_lanes.plain_calls
    partial = _port_partial(case)
    assert bls381_cuda.fold_lanes.plain_calls == before + 1
    got = ft.fq12_unpack_mont(
        pairing_torch.final_exponentiation(partial[None]))[0]

    aggs, coeffs, hashes, sigs = _inputs(ref_cv, case)
    want = None
    S = ref_cv.g2_infinity()
    for agg, c, h, sig in zip(aggs, coeffs, hashes, sigs):
        S = S + sig * c
        w, H = agg * c, h * ref_h2c.H_EFF
        if not (w.is_infinity() or H.is_infinity()):
            e = ref_pairing.pairing(w, H)
            want = e if want is None else want * e
    if not S.is_infinity():
        want = want * ref_pairing.pairing(-ref_cv.g1_generator(), S)
    assert _flat(got) == _flat(want)


@pytest.mark.slow
def test_fold_partial_product_equals_the_reference_xla_program(monkeypatch):
    import jax.numpy as jnp
    from consensus_specs_tpu.ops import curve_jax as cj
    from consensus_specs_tpu.ops import pairing_jax as pj
    monkeypatch.setattr(pj, "PAIRING_MODE", "staged")
    k = 4
    case = _case(k, np.random.default_rng([SEED, k]))
    aggs, coeffs, hashes, sigs = _inputs(ref_cv, case)
    lead = lambda a, *trail: jnp.asarray(a).reshape((1, k) + trail)
    want = pj.fold_partial_products(
        tuple(lead(c, 32) for c in cj.g1_pack(aggs)),
        lead(cj.scalars_to_bits(coeffs, n_bits=64), 64),
        tuple(lead(c, 2, 32) for c in cj.g2_pack(hashes)),
        tuple(lead(c, 2, 32) for c in cj.g2_pack(sigs)))
    got = _port_partial(case)
    assert np.array_equal(got.numpy(), np.asarray(want)[0])
