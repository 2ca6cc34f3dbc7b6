"""The port's G1/G2 Jacobian point ops (plain torch) against the oracle
(`crypto.curve`) and, under `slow`, the JAX package's `ops.curve_jax`.

`point_add` and `point_double` on seeded points and on the edge inputs the
reference's selects handle (infinity on either side, equal and negated
inputs), a short-bit scalar ladder, and one h_eff cofactor clear through
`g2_scalar_mul` (the ladder kernel's plain version on the CPU).  Points
compare as group elements against the oracle (it uses other formulas) and
limb for limb against the reference (the same formulas).
"""
import random

import numpy as np
import pytest
import torch

import consensus_specs_tpu_torch as port
from consensus_specs_tpu_torch.convert import (
    fq2_limbs_from_numpy, fq_limbs_from_numpy)
from consensus_specs_tpu_torch.crypto import curve as cv
from consensus_specs_tpu_torch.crypto import hash_to_curve as h2c
from consensus_specs_tpu_torch.ops import bls381_cuda
from consensus_specs_tpu_torch.ops import curve_torch as ct

SEED = 2026


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")


GROUPS = {
    "g1": (cv.g1_generator, cv.g1_infinity, ct.F1, ct.g1_pack, ct.g1_unpack),
    "g2": (cv.g2_generator, cv.g2_infinity, ct.F2, ct.g2_pack, ct.g2_unpack),
}


def _cases(group):
    """(p1, p2) pairs: generic, infinity either side, equal, negated."""
    gen, inf = GROUPS[group][:2]
    rng = random.Random(f"{SEED}-{group}")
    g = gen()
    a = g * rng.randrange(1, 2**64)
    b = g * rng.randrange(1, 2**64)
    return [(a, b), (inf(), b), (a, inf()), (inf(), inf()), (a, a),
            (a, -a), (b + a, a)]


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_point_add_and_double_equal_the_oracle(group):
    _gen, _inf, F, pack, unpack = GROUPS[group]
    cases = _cases(group)
    p1 = pack([p for p, _ in cases])
    p2 = pack([q for _, q in cases])
    added = unpack(ct.point_add(F, p1, p2))
    assert added == [p + q for p, q in cases]
    doubled = unpack(ct.point_double(F, p1))
    assert doubled == [p.double() for p, _ in cases]
    negated = unpack(ct.point_neg(F, p1))
    assert negated == [-p for p, _ in cases]


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_point_add_keeps_the_references_infinity_and_identity_rows(group):
    """Infinity on one side returns the other input as given; opposite
    inputs give (1, 1, 0) in Montgomery form; a double of infinity stays
    (1, 1, 0)."""
    _gen, inf, F, pack, _unpack = GROUPS[group]
    a, b = _cases(group)[0]
    p1, p2 = pack([inf(), a, a]), pack([b, inf(), -a])
    out = ct.point_add(F, p1, p2)
    for c in range(3):
        assert torch.equal(out[c][0], p2[c][0])
        assert torch.equal(out[c][1], p1[c][1])
    infinity = pack([inf()])
    assert all(torch.equal(out[c][2], infinity[c][0]) for c in range(3))
    dbl = ct.point_double(F, infinity)
    assert all(torch.equal(d, i) for d, i in zip(dbl, infinity))


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_short_scalar_ladder_equals_the_oracle(group):
    gen, _inf, F, pack, unpack = GROUPS[group]
    rng = random.Random(f"{SEED}-ladder-{group}")
    scalars = [0, 1, 2, rng.randrange(2**20), 2**20 - 1]
    pts = [gen() * rng.randrange(1, 2**32) for _ in scalars]
    bits = ct.scalars_to_bits(scalars, 20)
    got = unpack(ct.point_scalar_mul(F, pack(pts), bits))
    assert got == [p * s for p, s in zip(pts, scalars)]


def _hashed_points(n):
    out = []
    for i in range(n):
        u0, u1 = h2c.hash_to_field_fq2(bytes([i + 1]) * 7, 2, h2c.DST_G2)
        out.append(h2c.iso_map(*h2c.sswu_map(u0))
                   + h2c.iso_map(*h2c.sswu_map(u1)))
    return out


def test_h_eff_cofactor_clear_equals_the_oracle():
    from consensus_specs_tpu_torch.ops.bls_cuda import _H_EFF_BITS
    pre = _hashed_points(2)
    bits = torch.from_numpy(_H_EFF_BITS).expand(2, -1)
    before = bls381_cuda.g2_ladder.plain_calls
    out = ct.g2_scalar_mul(ct.g2_pack(pre), bits)
    assert bls381_cuda.g2_ladder.plain_calls == before + 1
    got = ct.g2_unpack(out)
    assert got == [p * h2c.H_EFF for p in pre]
    assert all(p.in_subgroup() and p.on_curve() for p in got)


def test_pack_round_trip_and_sum_tree():
    pts = [cv.g1_generator() * k for k in (3, 5, 7)]
    assert ct.g1_unpack(ct.g1_pack(pts)) == pts
    total = ct.g1_unpack(tuple(c[None] for c in ct.point_sum_tree(
        ct.F1, ct.g1_pack(pts))))
    assert total == [cv.g1_generator() * 15]


@pytest.mark.slow
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_point_ops_equal_the_reference_limb_for_limb(group):
    from consensus_specs_tpu.crypto import curve as jcv
    from consensus_specs_tpu.ops import curve_jax as cj
    jgen = {"g1": jcv.g1_generator, "g2": jcv.g2_generator}[group]
    jinf = {"g1": jcv.g1_infinity, "g2": jcv.g2_infinity}[group]
    jpack = {"g1": cj.g1_pack, "g2": cj.g2_pack}[group]
    conv = {"g1": fq_limbs_from_numpy, "g2": fq2_limbs_from_numpy}[group]
    rng = random.Random(f"{SEED}-jax-{group}")
    g = jgen()
    a, b = g * rng.randrange(1, 2**64), g * rng.randrange(1, 2**64)
    cases = [(a, b), (jinf(), b), (a, jinf()), (a, a), (a, -a)]
    j1, j2 = jpack([p for p, _ in cases]), jpack([q for _, q in cases])
    t1 = tuple(conv(np.asarray(c)) for c in j1)
    t2 = tuple(conv(np.asarray(c)) for c in j2)
    jadd = {"g1": cj.g1_add, "g2": cj.g2_add}[group](j1, j2)
    jdbl = {"g1": cj.g1_double, "g2": cj.g2_double}[group](j1)
    F = GROUPS[group][2]
    for got, want in ((ct.point_add(F, t1, t2), jadd),
                      (ct.point_double(F, t1), jdbl)):
        for g_c, w_c in zip(got, want):
            assert torch.equal(g_c, conv(np.asarray(w_c)))
    bits = np.zeros((5, 16), np.uint32)
    bits[:, -5:] = 1
    jmul = {"g1": cj.g1_scalar_mul, "g2": cj.g2_scalar_mul}[group](j1, bits)
    got = ct.point_scalar_mul(F, t1, torch.from_numpy(bits.astype(np.uint8)))
    for g_c, w_c in zip(got, jmul):
        assert torch.equal(g_c, conv(np.asarray(w_c)))
