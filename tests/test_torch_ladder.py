"""The windowed ladder's plain versions (ops/curve_torch.py) against the
oracle: the plain versions of K2 and the G2 ladder
(ops/csrc/bls381_ladder.cuh).

- The GLV split: s0 + s1 lambda = s (mod r) with s0, s1 < 2^128, on the
  edge scalars 0, 1, lambda - 1, lambda, 2^128, r - lambda, r - 1 and 32
  seeded scalars, and `glv_bits` rows that read back as the halves.
- phi(x, y) = (beta x, y) equals [lambda] P on the oracle (`crypto.curve`)
  for G1 and seeded multiples of it, and `point_phi` on limbs equals it.
- The recoding: every digit odd with |d| < 2^w, and the digits with the
  even correction give back s, at widths from 1 to 636 bits.
- `windowed_ladder` and `glv_ladder` equal the oracle's multiples
  (compressed bytes) on G1 at 64 and 256 bits (split and unsplit) and on
  G2 at 64 bits, with infinity rows and scalar 0.
- The kernel header's constants equal the plain version's.

Seeds from numpy; every hold is exact.  The JAX package's
`g1_weighted_sweep` and G2 fold are held in tests/test_torch_msm.py, the
kernel's device body compiled with g++ in tests/test_torch_bls381_host.py.
"""
import os
import re

import numpy as np
import pytest
import torch

import consensus_specs_tpu_torch as port
from consensus_specs_tpu_torch.crypto import curve as cv
from consensus_specs_tpu_torch.crypto.fields import Q, R
from consensus_specs_tpu_torch.ops import cuda_build, fq
from consensus_specs_tpu_torch.ops import curve_torch as ct

SEED = 2026
LAM = ct.GLV_LAMBDA
EDGES = [0, 1, LAM - 1, LAM, 2**128, R - LAM, R - 1]


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")


def _seeded_scalars(n, tag, bound_bits=255):
    rng = np.random.default_rng([SEED, tag])
    raw = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    return [int.from_bytes(row.tobytes(), "big") % (1 << bound_bits)
            for row in raw]


@pytest.mark.parametrize("case", ["edges", "seeded"])
def test_glv_split_recombines_mod_r(case):
    scalars = EDGES if case == "edges" else _seeded_scalars(32, 1, 256)
    for s in scalars:
        s0, s1 = ct.glv_split(s)
        assert (s0 + s1 * LAM - s) % R == 0
        assert 0 <= s0 < 2**128 and 0 <= s1 < 2**128
    rows = ct.glv_bits(scalars).numpy()
    assert rows.shape == (len(scalars), 2, ct.GLV_BITS)
    weights = [1 << i for i in range(ct.GLV_BITS - 1, -1, -1)]
    for s, row in zip(scalars, rows):
        halves = tuple(sum(w for w, b in zip(weights, r) if b) for r in row)
        assert halves == ct.glv_split(s)


def test_lambda_is_a_cube_root_of_unity_mod_r():
    assert LAM == 0xac45a4010001a40200000000ffffffff
    assert (LAM * LAM + LAM + 1) % R == 0
    assert hex(ct.GLV_BETA).startswith("0x1a0111ea397fe699ec")
    assert pow(ct.GLV_BETA, 3, Q) == 1 != ct.GLV_BETA


def test_phi_is_lambda_times_the_point():
    g = cv.g1_generator()
    pts = [g] + [g * int(k) for k in np.random.default_rng(
        [SEED, 2]).integers(1, 2**62, size=4)]
    for p in pts:
        x, y = p.affine()
        phi = cv.Point(cv.Fq1(ct.GLV_BETA * x.v % Q), y, cv.Fq1(1), cv.B1)
        assert phi == p * LAM
    got = ct.g1_unpack(ct.point_phi(ct.g1_pack(pts)))
    assert got == [p * LAM for p in pts]


@pytest.mark.parametrize("nbits", [1, 5, 6, 64, 128, 256, 636])
def test_recoding_gives_back_the_scalar(nbits):
    w = ct.LADDER_W
    top = (1 << nbits) - 1
    scalars = [0, 1, 2, top, top - 1] + _seeded_scalars(24, 3 + nbits, 256)
    if nbits > 256:
        scalars += [int(s) << (nbits - 256) for s in scalars[5:]]
    scalars = [s % (1 << nbits) for s in scalars]
    digits, even = ct.ladder_digits(ct.scalars_to_bits(scalars, nbits))
    m = digits.shape[1]
    assert m == max(1, -(-nbits // w))
    assert bool((digits % 2 != 0).all())
    assert bool((digits.abs() < (1 << w)).all())
    assert bool((digits[:, 0] > 0).all())
    for s, row, ev in zip(scalars, digits.tolist(), even.tolist()):
        value = sum(d << (w * (m - 1 - j)) for j, d in enumerate(row))
        assert ev == (s % 2 == 0)
        assert value - int(ev) == s


def _g1_case(n, tag):
    """n seeded multiples of G1, the second one infinity."""
    g = cv.g1_generator()
    pts = [g * int(k) for k in np.random.default_rng([SEED, tag]).integers(
        1, 2**62, size=n)]
    pts[1] = cv.g1_infinity()
    return pts


def _g2_case(n, tag):
    g = cv.g2_generator()
    pts = [g * int(k) for k in np.random.default_rng([SEED, tag]).integers(
        1, 2**62, size=n)]
    pts[1] = cv.g2_infinity()
    return pts


@pytest.mark.parametrize("case", ["g1-64", "g1-256-split", "g1-256",
                                  "g2-64"])
def test_windowed_ladder_equals_the_oracle(case):
    if case == "g2-64":
        pts = _g2_case(6, 4)
        scalars = [0, 3, 0, 1, 2**64 - 1] + [
            s % 2**64 for s in _seeded_scalars(1, 5)]
        got = ct.g2_unpack(ct.windowed_ladder(
            ct.F2, ct.g2_pack(pts), ct.scalars_to_bits(scalars, 64)))
        enc = cv.g2_to_bytes
    else:
        pts = _g1_case(len(EDGES) + 3, 6)
        if case == "g1-64":
            scalars = [0, 1, 0, 2, 2**64 - 1, 2**63] + [
                s % 2**64 for s in _seeded_scalars(4, 7)]
            bits = ct.scalars_to_bits(scalars, 64)
        else:
            scalars = [0] + EDGES[1:] + [0] + _seeded_scalars(2, 8)
            bits = ct.scalars_to_bits(scalars, 256)
        pack = ct.g1_pack(pts)
        if case == "g1-256-split":
            got = ct.g1_unpack(ct.glv_ladder(pack, ct.glv_bits(scalars)))
        else:
            got = ct.g1_unpack(ct.windowed_ladder(ct.F1, pack, bits))
        enc = cv.g1_to_bytes
    assert [enc(p) for p in got] == [enc(p * s) for p, s in zip(pts, scalars)]


def test_the_kernel_header_constants_equal_the_plain_version():
    src = open(os.path.join(cuda_build.CSRC, "bls381_ladder.cuh")).read()

    def define(name):
        return int(re.search(rf"#define {name} (\d+)", src).group(1))
    w = define("LADDER_W")
    assert w == ct.LADDER_W
    assert define("LADDER_SPLIT_BITS") == ct.GLV_BITS
    assert define("LADDER_ODD") == 1 << (w - 1)
    assert define("LADDER_LANES") == 1 << (w - 2)
    assert define("LADDER_EVEN_AT") == define("LADDER_ODD")
    assert define("LADDER_ENTRIES") == define("LADDER_ODD") + w - 1
    assert define("LADDER_SPLIT_ENTRIES") == \
        define("LADDER_ENTRIES") + define("LADDER_ODD")
    body = re.search(r"BLS_BETA\[BLS_NW\] = \{(.*?)\};", src, re.S).group(1)
    words = [int(x, 16) for x in re.findall(r"0x([0-9a-f]+)u", body)]
    beta = sum(x << (32 * i) for i, x in enumerate(words))
    assert beta == ct.GLV_BETA * fq.R_MONT % Q
    assert torch.equal(fq.to_words(fq.pack_mont([ct.GLV_BETA]))[0],
                       torch.tensor(words, dtype=torch.int64).to(
                           torch.int32))


@pytest.mark.parametrize("shape", [(2, 3, 128), (2, 2, 64), (3, 64), (2,)])
def test_g1_ladder_rejects_other_bit_layouts(shape):
    """K2's wrapper takes [n, nbits] or split [n, 2, 128] rows only."""
    from consensus_specs_tpu_torch.ops import bls381_cuda
    pt = ct.g1_pack([cv.g1_generator()] * 2)
    with pytest.raises(ValueError, match="expected bits"):
        bls381_cuda.g1_ladder(pt, torch.zeros(shape, dtype=torch.uint8))
