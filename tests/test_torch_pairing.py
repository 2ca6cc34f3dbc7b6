"""The port's batched pairing check (plain torch) against the oracle
(`crypto.pairing`) and, under `slow`, the JAX package's Miller products.

The identities `tests/test_pairing_jax.py` pins, as jobs of one batched
check: agreement with the oracle on valid and invalid products,
bilinearity (e(aP, Q) e(-P, aQ) = 1), the skip mask (a skipped pair
contributes one, whatever its coordinates) and the signature relation
(e(pk, H(m)) e(-g1, sig) = 1).  `miller_partial_products` and
`fq12_product_is_one` split the same check.  Verdicts are exact booleans;
Miller products are compared limb for limb.
"""
import random

import numpy as np
import pytest
import torch

import consensus_specs_tpu_torch as port
from consensus_specs_tpu_torch.convert import fq_limbs_from_numpy
from consensus_specs_tpu_torch.crypto import bls12_381 as native
from consensus_specs_tpu_torch.crypto import curve as cv
from consensus_specs_tpu_torch.crypto.hash_to_curve import hash_to_g2
from consensus_specs_tpu_torch.crypto.pairing import (
    pairing_check as oracle_check)
from consensus_specs_tpu_torch.ops import bls381_cuda, fq, pairing_torch
from consensus_specs_tpu_torch.ops import fq_tower as ft
from test_torch_bls381_host import host_lib  # noqa: F401  (fixture)

SEED = 2026


def _jobs():
    """name -> (pairs, skip flags); every job has two pairs."""
    rng = random.Random(SEED)
    g1, g2 = cv.g1_generator(), cv.g2_generator()
    a, b = rng.randrange(1, 2**64), rng.randrange(1, 2**64)
    sk = rng.randrange(1, 2**128)
    msg = b"pairing test message"
    sig = cv.g2_from_bytes(native.Sign(sk, msg))
    pk = g1 * sk
    h = hash_to_g2(msg)
    return {
        "valid": ([(g1 * a, g2 * b), (-(g1 * (a * b)), g2)], [False, False]),
        "invalid": ([(g1 * a, g2 * b), (-(g1 * (a * b + 1)), g2)],
                    [False, False]),
        "bilinear": ([(g1 * a, g2), (-g1, g2 * a)], [False, False]),
        "skip one pair": ([(g1 * a, g2), (g1 * 5, g2 * 7)], [True, False]),
        "skip both": ([(g1 * a, g2), (g1 * b, g2)], [True, True]),
        "signature": ([(pk, h), (-g1, sig)], [False, False]),
        "wrong signature": ([(pk * 2, h), (-g1, sig)], [False, False]),
    }


def _oracle(pairs, skips):
    return oracle_check([pq for pq, s in zip(pairs, skips) if not s])


def _pack(jobs):
    xs1, ys1, xs2, ys2, skips = [], [], [], [], []
    for pairs, skip in jobs:
        for (p, q), s in zip(pairs, skip):
            (x1, y1), (x2, y2) = p.affine(), q.affine()
            xs1.append(x1.v)
            ys1.append(y1.v)
            xs2.append(x2)
            ys2.append(y2)
            skips.append(s)
    b = len(jobs)
    return (fq.pack_mont(xs1).reshape(b, 2, 32),
            fq.pack_mont(ys1).reshape(b, 2, 32),
            ft.fq2_pack_mont(xs2).reshape(b, 2, 2, 32),
            ft.fq2_pack_mont(ys2).reshape(b, 2, 2, 32),
            torch.tensor(skips).reshape(b, 2))


@pytest.fixture(scope="module")
def checked():
    """One batched check of every job, run once: (names, inputs, Miller
    values [b, 2, 12, 32], products, verdicts)."""
    port.set_device("cpu")
    jobs = _jobs()
    names = list(jobs)
    args = _pack([jobs[n] for n in names])
    b = len(names)
    f = bls381_cuda.miller(*(a.reshape((2 * b,) + a.shape[2:])
                             for a in args))
    prod, ok = bls381_cuda.product_final(f.reshape(b, 2, 12, 32))
    return names, jobs, args, f.reshape(b, 2, 12, 32), prod, ok.tolist()


def test_verdicts_equal_the_oracle(checked):
    names, jobs, _args, _f, _prod, ok = checked
    assert ok == [_oracle(*jobs[n]) for n in names]
    assert dict(zip(names, ok)) == {
        "valid": True, "invalid": False, "bilinear": True,
        "skip one pair": False, "skip both": True, "signature": True,
        "wrong signature": False}


def test_skipped_pairs_contribute_one(checked):
    names, jobs, _args, f, _prod, _ok = checked
    one = ft.fq12_one()
    for j, name in enumerate(names):
        for i, s in enumerate(jobs[name][1]):
            assert torch.equal(f[j, i], one) == s


def test_partial_products_and_product_is_one_split_the_check(checked):
    names, _jobs, args, f, prod, ok = checked
    manual = torch.stack([ft.fq12_mul(f[j, 0], f[j, 1])
                          for j in range(len(names))])
    assert torch.equal(prod, manual)
    j = names.index("valid")
    parts = pairing_torch.miller_partial_products(
        *(a[j:j + 1] for a in args))
    assert torch.equal(parts[0], prod[j])
    assert pairing_torch.fq12_product_is_one(f[j]) is True
    no_final, none = bls381_cuda.product_final(f[j:j + 1], final=False)
    assert none is None and torch.equal(no_final[0], prod[j])


def test_kernel_device_functions_equal_the_plain_version(checked,
                                                        host_lib):  # noqa: F811
    """The pairing launches' per-pair and per-job bodies (the four-warp
    levels of bls381_pairing.cuh), compiled as host C++
    (tests/test_torch_bls381_host.py), on the same inputs: Miller values,
    products and verdicts bit for bit."""
    names, _jobs, args, f, prod, ok = checked
    b = len(names)
    xp, yp, xq, yq, skip = (a.reshape((2 * b,) + a.shape[2:]) for a in args)
    g1w = fq.to_words(torch.stack([xp, yp], 1)).contiguous()
    g2w = fq.to_words(torch.stack([xq, yq], 1)).contiguous()
    skip8 = skip.to(torch.uint8).contiguous()
    got_f = torch.empty((2 * b, 12, 12), dtype=torch.int32)
    host_lib.miller(g1w.data_ptr(), g2w.data_ptr(), skip8.data_ptr(),
                    got_f.data_ptr(), 2 * b)
    assert torch.equal(fq.from_words(got_f).reshape(b, 2, 12, 32), f)
    got_prod = torch.empty((b, 12, 12), dtype=torch.int32)
    got_ok = torch.zeros(b, dtype=torch.uint8)
    host_lib.final(got_f.data_ptr(), 2, 1, got_prod.data_ptr(),
                   got_ok.data_ptr(), b)
    assert torch.equal(fq.from_words(got_prod), prod)
    assert got_ok.tolist() == [int(v) for v in ok]


def test_pairing_check_entry_point():
    """`pairing_check` over a [2, 2]-shaped batch of the valid and invalid
    jobs, through the four-warp check's plain version (one call, no
    kernel, and neither of the two-launch kernel's launches)."""
    jobs = _jobs()
    args = _pack([jobs["valid"], jobs["invalid"]])
    calls = (bls381_cuda.pairing_check.plain_calls,
             bls381_cuda.miller.plain_calls,
             bls381_cuda.product_final.plain_calls)
    launches = (bls381_cuda.pairing_check.launches,
                bls381_cuda.miller.launches,
                bls381_cuda.product_final.launches)
    assert pairing_torch.pairing_check(*args).tolist() == [True, False]
    assert (bls381_cuda.pairing_check.plain_calls,
            bls381_cuda.miller.plain_calls,
            bls381_cuda.product_final.plain_calls) == (calls[0] + 1,
                                                       calls[1], calls[2])
    assert (bls381_cuda.pairing_check.launches,
            bls381_cuda.miller.launches,
            bls381_cuda.product_final.launches) == launches


def test_check_plain_equals_miller_and_product_final(checked):
    """The four-warp check's plain version (one Miller accumulator a job,
    the lines multiplied by halving) on every job: its product before the
    final exponentiation and its verdict equal launch 1 + launch 2's."""
    _names, _jobs, args, _f, prod, ok = checked
    got_prod, got_ok = pairing_torch.check_plain(*args)
    assert torch.equal(got_prod, prod)
    assert got_ok.tolist() == ok


@pytest.mark.slow
def test_miller_products_equal_the_reference_limb_for_limb(checked):
    from consensus_specs_tpu.ops import pairing_jax as pj
    names, _jobs, args, _f, prod, _ok = checked
    want = pj.miller_partial_products(
        *(a.numpy().astype(np.uint32) for a in args[:4]), args[4].numpy())
    assert torch.equal(prod, fq_limbs_from_numpy(np.asarray(want)))
