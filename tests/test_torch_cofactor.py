"""The port's G2 cofactor clearing by psi (plain torch) against the JAX
package, and the check-by-check path's routing through the redesigned
kernels' wrappers.

`bls_cuda.hash_to_g2_batch` clears the cofactor with
`bls381_cuda.clear_cofactor_g2` (csrc/bls381_cofactor.cu on the card, its
plain version `curve_torch.clear_cofactor_g2_plain` on the CPU), where the
JAX package ran a 636-bit h_eff ladder (`ops/bls_tpu.py` `hash_to_g2_batch`)
whose oracle is `crypto/hash_to_curve.py` `hash_to_g2`.  Points compare as
affine integers; psi's constants are checked by its eigenvalue on G2.
"""
import pytest
import torch

import consensus_specs_tpu_torch as port
from consensus_specs_tpu_torch.crypto import curve as cv
from consensus_specs_tpu_torch.crypto.fields import BLS_X, R
from consensus_specs_tpu_torch.ops import bls381_cuda, bls_cuda
from consensus_specs_tpu_torch.ops import curve_torch as ct
from consensus_specs_tpu_torch.ops import fq_tower as ft
from consensus_specs_tpu_torch.ops import pairing_torch

SEED = 2026


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")


def _messages():
    return [SEED.to_bytes(4, "big") + bytes([i]) * 28 for i in range(4)]


def test_hash_to_g2_batch_equals_the_reference():
    """Four seeded messages: the port's batch (one plain cofactor call, no
    ladder, no field op) against the JAX package's `hash_to_g2`."""
    from consensus_specs_tpu.crypto import hash_to_curve as ref_h2c
    calls = (bls381_cuda.clear_cofactor_g2.plain_calls,
             bls381_cuda.g2_ladder.plain_calls,
             bls381_cuda.field_op.plain_calls)
    got = bls_cuda.hash_to_g2_batch(_messages())
    assert (bls381_cuda.clear_cofactor_g2.plain_calls,
            bls381_cuda.g2_ladder.plain_calls,
            bls381_cuda.field_op.plain_calls) == (calls[0] + 1, calls[1],
                                                  calls[2])
    for p, msg in zip(got, _messages()):
        want = ref_h2c.hash_to_g2(msg)
        (x, y), (wx, wy) = p.affine(), want.affine()
        assert (x.c0, x.c1, y.c0, y.c1) == (wx.c0, wx.c1, wy.c0, wy.c1)
        assert p.in_subgroup()


def test_psi_acts_as_x_on_g2():
    """psi's constants from crypto.fields: on G2, psi is multiplication by
    x (mod r), the Frobenius eigenvalue."""
    g = cv.g2_generator() * 0xC0FFEE
    got = ct.g2_unpack(ct.point_psi(ct.g2_pack([g]), ct.psi_consts()))[0]
    assert got == g * (BLS_X % R)


def test_pairing_check_routes_through_the_warp_check():
    """`pairing_torch.pairing_check` takes `bls381_cuda.pairing_check` (one
    plain call for the batch), not the two-launch pairing kernel, and its
    product equals `miller_loop` + `product_final`."""
    g1, g2 = cv.g1_generator(), cv.g2_generator()
    jobs = [[(g1 * 3, g2 * 5), (-(g1 * 15), g2)],
            [(g1 * 3, g2 * 5), (-(g1 * 16), g2)]]
    xs1, ys1, xs2, ys2 = [], [], [], []
    for job in jobs:
        for p, q in job:
            (x1, y1), (x2, y2) = p.affine(), q.affine()
            xs1.append(x1.v)
            ys1.append(y1.v)
            xs2.append(x2)
            ys2.append(y2)
    from consensus_specs_tpu_torch.ops import fq
    xp, yp = fq.pack_mont(xs1), fq.pack_mont(ys1)
    xq, yq = ft.fq2_pack_mont(xs2), ft.fq2_pack_mont(ys2)
    old = (bls381_cuda.miller.plain_calls,
           bls381_cuda.product_final.plain_calls)
    calls = bls381_cuda.pairing_check.plain_calls
    ok = pairing_torch.pairing_check(
        xp.reshape(2, 2, 32), yp.reshape(2, 2, 32),
        xq.reshape(2, 2, 2, 32), yq.reshape(2, 2, 2, 32))
    assert ok.tolist() == [True, False]
    assert bls381_cuda.pairing_check.plain_calls == calls + 1
    assert (bls381_cuda.miller.plain_calls,
            bls381_cuda.product_final.plain_calls) == old
    skip = torch.zeros(2, 2, dtype=torch.bool)
    prod, _ = bls381_cuda.pairing_check(
        xp.reshape(2, 2, 32), yp.reshape(2, 2, 32),
        xq.reshape(2, 2, 2, 32), yq.reshape(2, 2, 2, 32), skip)
    f = pairing_torch.miller_loop(xp, yp, xq, yq)
    want, _ = pairing_torch.product_final(f.reshape(2, 2, 12, 32))
    assert torch.equal(prod, want)


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        bls381_cuda.clear_cofactor_g2(
            tuple(torch.zeros(2, 32, dtype=torch.int64) for _ in range(3)))
    z = torch.zeros(1, 2, 32, dtype=torch.int64)
    with pytest.raises(ValueError):
        bls381_cuda.pairing_check(z, z, z, z, torch.zeros(1, 2,
                                                          dtype=torch.bool))
