"""The port's Fiat-Shamir weighting and G2 fold against the JAX package's.

`ops/msm.g1_weighted_sweep` (per-pair s_i P_i, the G1 ladder kernel's
plain version on the CPU) against the JAX package's `g1_weighted_sweep`
(its host engine on the CPU), and `ops/msm.g2_multi_exp` (the G2 ladder
and a segment sum) against the JAX package's G2 fold of the same flush
(`sigpipe/fold._fold_sweep`, its host engine on the CPU) and, under
`slow`, against its XLA `g2_multi_exp` (a compile of minutes here).  The
same seeded points and scalars cross the package line as affine integers;
results are compared as points, compressed, byte for byte.  The scalars
are the scheduler's 64-bit coefficients, with edges: 0, 1, 2^64 - 1, one
wider than 64 bits (the 256-bit rows) and one above the group order
(reduced mod r), on points that include infinity.
"""
import numpy as np
import pytest

import consensus_specs_tpu_torch as port
from consensus_specs_tpu.crypto import curve as ref_cv
from consensus_specs_tpu.ops import g1_sweep as ref_sweep
from consensus_specs_tpu.ops import msm as ref_msm
from consensus_specs_tpu.sigpipe import fold as ref_fold
from consensus_specs_tpu_torch.crypto import curve as cv
from consensus_specs_tpu_torch.crypto.fields import R
from consensus_specs_tpu_torch.ops import bls381_cuda, msm

SEED = 2026


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    port.set_device("cpu")
    monkeypatch.setattr(ref_sweep, "G1_SWEEP_MODE", "oracle")


def _case(group, n, wide, rng):
    """(points as affine integers, scalars): n seeded multiples of the
    group's generator, the second one infinity (None), and seeded 64-bit
    scalars whose first entries are the edges; `wide` adds a 200-bit
    scalar and one above r."""
    g1 = group == "g1"
    gen = cv.g1_generator() if g1 else cv.g2_generator()
    affine = []
    for s in rng.integers(1, 2**62, size=n):
        x, y = (gen * int(s)).affine()
        affine.append((x.v, y.v) if g1 else (x.c0, x.c1, y.c0, y.c1))
    affine[1] = None
    scalars = [int(s) for s in rng.integers(0, 2**63, size=n,
                                            dtype=np.uint64)]
    scalars[:3] = [0, 1, 2**64 - 1]
    if wide:
        scalars[3] = int(rng.integers(1, 2**62)) << 138
        scalars[4] = R + 12345
    return affine, scalars


def _points(module, group, affine):
    """The affine integers as `module`'s (the port's or the reference's)
    oracle points."""
    out = []
    for xy in affine:
        if group == "g1":
            out.append(module.g1_infinity() if xy is None else module.Point(
                module.Fq1(xy[0]), module.Fq1(xy[1]), module.Fq1(1),
                module.B1))
        else:
            out.append(module.g2_infinity() if xy is None else module.Point(
                module.Fq2(xy[0], xy[1]), module.Fq2(xy[2], xy[3]),
                module.Fq2(1, 0), module.B2))
    return out


def _bytes(module, group, pts):
    enc = module.g1_to_bytes if group == "g1" else module.g2_to_bytes
    return [enc(p) for p in pts]


@pytest.mark.parametrize("wide", [False, True], ids=["64-bit", "wide"])
def test_g1_weighted_sweep_equals_the_reference(wide):
    rng = np.random.default_rng([SEED, 1, wide])
    affine, scalars = _case("g1", 7, wide, rng)
    before = bls381_cuda.g1_ladder.plain_calls
    got = msm.g1_weighted_sweep(_points(cv, "g1", affine), scalars)
    want = ref_msm.g1_weighted_sweep(_points(ref_cv, "g1", affine), scalars)
    assert _bytes(cv, "g1", got) == _bytes(ref_cv, "g1", want)
    assert bls381_cuda.g1_ladder.plain_calls == before + 1


def test_g2_multi_exp_equals_the_reference_fold():
    rng = np.random.default_rng([SEED, 2])
    affine, scalars = _case("g2", 5, False, rng)
    before = (bls381_cuda.g2_ladder.plain_calls,
              bls381_cuda.segment_sum.plain_calls)
    got = msm.g2_multi_exp(_points(cv, "g2", affine), scalars)
    want = ref_fold._fold_sweep(_points(ref_cv, "g2", affine), scalars)
    assert cv.g2_to_bytes(got) == ref_cv.g2_to_bytes(want)
    assert (bls381_cuda.g2_ladder.plain_calls,
            bls381_cuda.segment_sum.plain_calls) == (before[0] + 1,
                                                     before[1] + 1)


def test_empty_and_mismatched_inputs():
    assert msm.g1_weighted_sweep([], []) == []
    assert msm.g2_multi_exp([], []).is_infinity()
    g = cv.g1_generator()
    with pytest.raises(ValueError, match="length mismatch"):
        msm.g1_weighted_sweep([g], [1, 2])
    with pytest.raises(ValueError, match="length mismatch"):
        msm.g2_multi_exp([cv.g2_generator()], [])


@pytest.mark.slow
def test_g2_multi_exp_equals_the_reference_xla_program():
    rng = np.random.default_rng([SEED, 3])
    affine, scalars = _case("g2", 5, True, rng)
    got = msm.g2_multi_exp(_points(cv, "g2", affine), scalars)
    want = ref_msm.g2_multi_exp(_points(ref_cv, "g2", affine), scalars)
    assert cv.g2_to_bytes(got) == ref_cv.g2_to_bytes(want)
