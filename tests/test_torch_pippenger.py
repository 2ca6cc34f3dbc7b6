"""The port's G1 multi-scalar multiplication against the JAX package's.

`ops/msm._pippenger_g1`, the plain version of the Pippenger kernel
(ops/csrc/bls381_pippenger.cu), runs here at 4-bit windows and 4 bucket
lanes, where it costs seconds: its result equals the host Pippenger oracle
`crypto/curve.msm` of both packages, on the reference test's edge rows
(scalars 0, 1, r - 1, a lowest-window and a highest-window scalar, an
infinity point) and a count of points that is not a multiple of the lanes
(the engine's padding).  `g1_multi_exp` below 256 points (the lanes engine:
the G1 ladder's and the segment sum's plain versions) equals the
reference's host result.  The kernel's device bodies are held bit for bit
against the plain version, and at the reference's parameters against the
oracle, in tests/test_torch_bls381_host.py.

Under `slow` (about 8 minutes each here): the plain version at the
reference's parameters (8-bit windows, 16 lanes) against the JAX package's
XLA `_pippenger_g1`, limb for limb, and through the wrapper at 300 points
(padded to 512) against the oracle.
"""
import numpy as np
import pytest
import torch

import consensus_specs_tpu_torch as port
from consensus_specs_tpu.crypto import curve as ref_cv
from consensus_specs_tpu_torch.crypto import curve as cv
from consensus_specs_tpu_torch.crypto.fields import R
from consensus_specs_tpu_torch.ops import bls381_cuda, curve_torch, msm

SEED = 2026


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")
    yield
    port.set_device("cpu")


def _case(n, w_bits, seed):
    """n seeded points (multiples of G1 by 32 distinct seeded factors, in
    turn) and n seeded scalars below r, with the reference test's edge
    rows: scalars 0, 1, r - 1, 2^w_bits - 1 (the lowest window alone),
    2^(256 - w_bits) (the highest window alone) and an infinity point.
    The points are decoded from their bytes (Z = 1), as both packages
    would read them."""
    rng = np.random.default_rng([SEED, seed, n])
    g = cv.g1_generator()
    base = [cv.g1_from_bytes(cv.g1_to_bytes(g * int(k)),
                             subgroup_check=False)
            for k in rng.integers(1, 2**62, size=32)]
    pts = [base[i % 32] for i in range(n)]
    raw = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    scalars = [int.from_bytes(row.tobytes(), "big") % R for row in raw]
    scalars[:5] = [0, 1, R - 1, (1 << w_bits) - 1, 1 << (256 - w_bits)]
    pts[5] = cv.g1_infinity()
    return pts, scalars


def _to_ref(pts):
    return [ref_cv.g1_from_bytes(cv.g1_to_bytes(p), subgroup_check=False)
            for p in pts]


def _point(out):
    return curve_torch.g1_unpack(tuple(c[None] for c in out))[0]


@pytest.mark.parametrize("w_bits", [4, 8])
def test_digits_equal_the_reference_windows(w_bits):
    from consensus_specs_tpu.ops import msm as ref_msm
    _pts, scalars = _case(40, w_bits, 1)
    digits = msm._digits_np(scalars, w_bits)
    n_win = 256 // w_bits
    want = np.array([[(s >> (w_bits * (n_win - 1 - w))) & ((1 << w_bits) - 1)
                      for s in scalars] for w in range(n_win)])
    assert digits.shape == (n_win, 40)
    assert np.array_equal(digits, want)
    if w_bits == msm._W_BITS:
        assert np.array_equal(digits, ref_msm._digits_np(scalars))


def test_plain_pippenger_equals_both_oracles_at_small_windows():
    """18 points (not a multiple of the 4 lanes: padded to 32 with
    infinity and scalar 0) at 4-bit windows."""
    pts, scalars = _case(18, 4, 2)
    pt, digits = msm._pippenger_inputs(pts, scalars, "cpu", 4, 4)
    assert pt[0].shape == (32, 32) and digits.shape == (64, 32)
    got = _point(msm._pippenger_g1(*pt, digits, w_bits=4, threads=4))
    want = cv.g1_to_bytes(cv.msm(pts, scalars))
    assert cv.g1_to_bytes(got) == want
    assert ref_cv.g1_to_bytes(ref_cv.msm(_to_ref(pts), scalars)) == want


def test_lanes_engine_equals_the_reference_host_result():
    pts, scalars = _case(6, 8, 3)
    scalars[5] = R + 99                          # reduced mod r
    before = (bls381_cuda.g1_ladder.plain_calls,
              bls381_cuda.segment_sum.plain_calls,
              bls381_cuda.pippenger_g1.plain_calls)
    got = msm.g1_multi_exp(pts, scalars)
    want = ref_cv.msm(_to_ref(pts), scalars)
    assert cv.g1_to_bytes(got) == ref_cv.g1_to_bytes(want)
    assert (bls381_cuda.g1_ladder.plain_calls,
            bls381_cuda.segment_sum.plain_calls,
            bls381_cuda.pippenger_g1.plain_calls) == (
        before[0] + 1, before[1] + 1, before[2])


def test_engine_follows_the_device_on_every_call(monkeypatch):
    """At n >= _PIPPENGER_MIN the card takes the Pippenger kernel and the
    CPU the lanes engine, read from the device at each call: a CPU call,
    then a card call, then a CPU call again."""
    class Routed(Exception):
        pass

    def kernel(device, _digits):
        raise Routed(device.type)

    monkeypatch.setattr(msm, "_PIPPENGER_MIN", 4)
    pts, scalars = _case(6, 8, 8)
    want = cv.g1_to_bytes(cv.msm(pts, scalars))
    ladder = bls381_cuda.g1_ladder.plain_calls
    assert cv.g1_to_bytes(msm.g1_multi_exp(pts, scalars)) == want
    assert bls381_cuda.g1_ladder.plain_calls == ladder + 1
    on_card = torch.device("cuda")
    with monkeypatch.context() as m:
        m.setattr(msm, "_device", lambda: on_card)
        m.setattr(msm, "_pippenger_inputs", lambda p, s, d: (d, None))
        m.setattr(bls381_cuda, "pippenger_g1", kernel)
        with pytest.raises(Routed, match="cuda"):
            msm.g1_multi_exp(pts, scalars)
    assert cv.g1_to_bytes(msm.g1_multi_exp(pts, scalars)) == want
    assert bls381_cuda.g1_ladder.plain_calls == ladder + 2


def test_device_msm_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port.set_device("cuda")
    pts, scalars = _case(256, 8, 4)
    with pytest.raises(RuntimeError, match="CUDA card"):
        msm.g1_multi_exp(pts, scalars)


def test_wrapper_checks_its_inputs():
    pts, scalars = _case(16, 8, 5)
    pt, digits = msm._pippenger_inputs(pts, scalars, "cpu")
    with pytest.raises(ValueError, match="multiple of 16"):
        bls381_cuda.pippenger_g1(tuple(c[:8] for c in pt), digits[:, :8])
    with pytest.raises(ValueError, match="digits"):
        bls381_cuda.pippenger_g1(pt, digits[:16])
    assert msm.g1_multi_exp([], []).is_infinity()
    with pytest.raises(ValueError, match="length mismatch"):
        msm.g1_multi_exp(pts, scalars[:3])


@pytest.mark.slow
def test_plain_pippenger_equals_the_reference_xla_program():
    import jax.numpy as jnp
    from consensus_specs_tpu.ops import curve_jax as ref_cj
    from consensus_specs_tpu.ops import msm as ref_msm
    pts, scalars = _case(256, 8, 6)
    pt, digits = msm._pippenger_inputs(pts, scalars, "cpu")
    got = msm._pippenger_g1(*pt, digits)
    X, Y, Z = ref_cj.g1_pack(_to_ref(pts))
    want = ref_msm._pippenger_g1(X, Y, Z, jnp.asarray(
        ref_msm._digits_np(scalars)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


@pytest.mark.slow
def test_pippenger_engine_pads_at_the_reference_parameters():
    pts, scalars = _case(300, 8, 7)
    pt, digits = msm._pippenger_inputs(pts, scalars, "cpu")
    assert pt[0].shape == (512, 32) and digits.shape == (32, 512)
    before = bls381_cuda.pippenger_g1.plain_calls
    got = _point(bls381_cuda.pippenger_g1(pt, digits))
    assert bls381_cuda.pippenger_g1.plain_calls == before + 1
    assert cv.g1_to_bytes(got) == cv.g1_to_bytes(cv.msm(pts, scalars))
