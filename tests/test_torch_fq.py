"""The port's BLS12-381 field and tower (plain torch) against the JAX
package's limbs and the pure-Python oracle.

- Fq: every op of `consensus_specs_tpu_torch.ops.fq` on 64 seeded elements
  plus 0, 1 and q - 1 equals `consensus_specs_tpu.ops.fq` run eagerly on the
  CPU, limb for limb (the reference's uint32 limbs carried over by
  `convert.fq_limbs_from_numpy`); a full carry ripple resolves exactly.
- Words: `to_words`/`from_words` round trip, and the words are the integer.
- Tower: the Fq2, Fq6 and Fq12 ops, the Frobenius maps, the cyclotomic
  square on unitary elements, the inverses and the fixed power equal
  `crypto.fields`; under `slow`, the Fq12 product, square and cyclotomic
  square on non-unitary elements equal `consensus_specs_tpu.ops.fq_tower`
  limb for limb.
- The field kernel's op codes (`bls381_cuda.FIELD_OPS`) are the order of
  `enum FieldOp` in csrc/bls381.cuh.

Every tolerance is exact: field elements are integers.
"""
import os
import random
import re

import numpy as np
import pytest
import torch

import consensus_specs_tpu_torch as port
from consensus_specs_tpu.crypto import fields as jfields
from consensus_specs_tpu.ops import fq as jfq
from consensus_specs_tpu_torch.convert import fq_limbs_from_numpy
from consensus_specs_tpu_torch.crypto.fields import Q, Fq2, Fq6, Fq12
from consensus_specs_tpu_torch.ops import bls381_cuda, fq
from consensus_specs_tpu_torch.ops import fq_tower as ft

SEED = 2026
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")


def _ints(rng, n):
    return [rng.randrange(Q) for _ in range(n)] + [0, 1, Q - 1]


@pytest.fixture(scope="module")
def operands():
    rng = random.Random(SEED)
    xs, ys = _ints(rng, 64), _ints(rng, 64)
    ys[-3:] = [Q - 1, 0, Q - 1]      # 0 - (q-1), 1 * 0, (q-1)^2
    return xs, ys


def _jax_limbs(fn, *arrays):
    return fq_limbs_from_numpy(np.asarray(fn(*arrays)))


FQ_OPS = {
    "add": (fq.add, jfq.add, lambda x, y: x + y),
    "sub": (fq.sub, jfq.sub, lambda x, y: x - y),
    "mul": (fq.mul, jfq.mul, lambda x, y: x * y),
    "neg": (lambda a, b: fq.neg(a), lambda a, b: jfq.neg(a),
            lambda x, y: -x),
    "square": (lambda a, b: fq.square(a), lambda a, b: jfq.square(a),
               lambda x, y: x * x),
}


@pytest.mark.parametrize("name", sorted(FQ_OPS))
def test_fq_op_equals_the_reference_limb_for_limb(operands, name):
    xs, ys = operands
    ours, theirs, oracle = FQ_OPS[name]
    a, b = fq.pack_mont(xs), fq.pack_mont(ys)
    ja, jb = jfq.pack_mont(xs), jfq.pack_mont(ys)
    got = ours(a, b)
    assert got.dtype == torch.int64
    assert torch.equal(got, _jax_limbs(theirs, ja, jb))
    assert fq.unpack_mont(got) == [oracle(x, y) % Q for x, y in zip(xs, ys)]


def test_mont_conversions_equal_the_reference(operands):
    xs, _ = operands
    plain = fq.pack(xs)
    assert torch.equal(plain, fq_limbs_from_numpy(np.asarray(jfq.pack(xs))))
    mont = fq.to_mont(plain)
    assert torch.equal(mont, _jax_limbs(jfq.to_mont, jfq.pack(xs)))
    assert torch.equal(mont, fq.pack_mont(xs))
    assert torch.equal(fq.from_mont(mont), plain)
    assert fq.unpack(fq.from_mont(mont)) == xs


def test_conditional_subtract_of_q(operands):
    xs, _ = operands
    raw = [x + Q for x in xs[:8]] + xs[:8]      # values below 2q
    limbs = torch.from_numpy(np.stack([fq._int_to_limbs_np(v) for v in raw]))
    assert fq.unpack(fq._csub_q(limbs)) == [x % Q for x in raw]


def test_full_carry_ripple_resolves():
    """2^372 - 1 has 31 limbs of 2^12 - 1: adding 1 ripples through all."""
    x = (1 << 372) - 1
    assert fq.unpack(fq.add(fq.pack([x, Q - 2]), fq.pack([1, 1]))) == \
        [1 << 372, Q - 1]
    assert fq.unpack(fq.sub(fq.pack([1 << 372]), fq.pack([1]))) == [x]


def test_words_round_trip_and_are_the_integer(operands):
    xs, _ = operands
    limbs = fq.pack(xs)
    words = fq.to_words(limbs)
    assert words.dtype == torch.int32 and words.shape == (len(xs), 12)
    assert torch.equal(fq.from_words(words), limbs)
    for x, row in zip(xs, words.tolist()):
        assert sum((w & 0xFFFFFFFF) << (32 * i) for i, w in enumerate(row)) \
            == x


# ---------------------------------------------------------------------------
# tower against the oracle
# ---------------------------------------------------------------------------

def _fq2(rng):
    return Fq2(rng.randrange(Q), rng.randrange(Q))


def _fq6(rng):
    return Fq6(_fq2(rng), _fq2(rng), _fq2(rng))


def _fq12(rng):
    return Fq12(_fq6(rng), _fq6(rng))


def _unitary(f):
    """f^((q^6 - 1)(q^2 + 1)): in the cyclotomic subgroup."""
    f1 = f.conjugate() * f.inv()
    return f1.frobenius(2) * f1


N_TOWER = 3

TOWER_OPS = {
    "fq2_mul": (_fq2, 2, ft.fq2_mul, lambda a, b: a * b),
    "fq2_square": (_fq2, 1, ft.fq2_square, lambda a: a * a),
    "fq2_mul_xi": (_fq2, 1, ft.fq2_mul_xi, lambda a: a.mul_by_xi()),
    "fq2_conj": (_fq2, 1, ft.fq2_conj, lambda a: a.conjugate()),
    "fq2_inv": (_fq2, 1, ft.fq2_inv, lambda a: a.inv()),
    "fq6_mul": (_fq6, 2, ft.fq6_mul, lambda a, b: a * b),
    "fq6_mul_by_v": (_fq6, 1, ft.fq6_mul_by_v, lambda a: a.mul_by_v()),
    "fq6_inv": (_fq6, 1, ft.fq6_inv, lambda a: a.inv()),
    "fq12_mul": (_fq12, 2, ft.fq12_mul, lambda a, b: a * b),
    "fq12_square": (_fq12, 1, ft.fq12_square, lambda a: a * a),
    "fq12_conj": (_fq12, 1, ft.fq12_conj, lambda a: a.conjugate()),
    "fq12_inv": (_fq12, 1, ft.fq12_inv, lambda a: a.inv()),
    "fq12_frobenius1": (_fq12, 1, lambda a: ft.fq12_frobenius(a, 1),
                        lambda a: a.frobenius(1)),
    "fq12_frobenius2": (_fq12, 1, lambda a: ft.fq12_frobenius(a, 2),
                        lambda a: a.frobenius(2)),
    "fq12_frobenius3": (_fq12, 1, lambda a: ft.fq12_frobenius(a, 3),
                        lambda a: a.frobenius(3)),
    "fq12_cyclotomic_square": (
        lambda rng: _unitary(_fq12(rng)), 1, ft.fq12_cyclotomic_square,
        lambda a: a * a),
    "fq12_pow_fixed": (
        _fq12, 1,
        lambda a: ft.fq12_pow_fixed(a, [int(b) for b in bin(0xD2010001)[2:]]),
        lambda a: a.pow(0xD2010001)),
}

PACK = {2: (ft.fq2_pack_mont, ft.fq2_unpack_mont),
        6: (ft.fq6_pack_mont, ft.fq6_unpack_mont),
        12: (ft.fq12_pack_mont, ft.fq12_unpack_mont)}


def _degree(make):
    v = make(random.Random(0))
    return {Fq2: 2, Fq6: 6, Fq12: 12}[type(v)]


@pytest.mark.parametrize("name", sorted(TOWER_OPS))
def test_tower_op_equals_the_oracle(name):
    make, arity, ours, oracle = TOWER_OPS[name]
    rng = random.Random(f"{SEED}-{name}")
    args = [[make(rng) for _ in range(N_TOWER)] for _ in range(arity)]
    pack, unpack = PACK[_degree(make)]
    got = unpack(ours(*(pack(a) for a in args)))
    assert got == [oracle(*vals) for vals in zip(*args)]


def test_inverses_of_zero_are_zero():
    for deg, (pack, unpack) in PACK.items():
        zero = {2: Fq2.zero, 6: Fq6.zero, 12: Fq12.zero}[deg]()
        inv = {2: ft.fq2_inv, 6: ft.fq6_inv, 12: ft.fq12_inv}[deg]
        assert unpack(inv(pack([zero]))) == [zero]
    assert fq.unpack(ft.fq_inv(fq.pack([0]))) == [0]


def test_frobenius_constants_are_the_oracles():
    for j, k in enumerate(ft._FROB_K):
        g = jfields._FROB_GAMMA[k]
        assert ft.fq2_unpack_mont(
            torch.from_numpy(ft._FROB_GAMMA_LIMBS[j:j + 1])) == \
            [Fq2(g.c0, g.c1)]


def test_field_op_codes_follow_the_kernel_enum():
    src = open(os.path.join(ROOT, "consensus_specs_tpu_torch", "ops", "csrc",
                            "bls381.cuh")).read()
    body = re.search(r"enum FieldOp \{(.*?)\};", src, re.S).group(1)
    codes = [c.strip() for c in body.replace("\n", " ").split(",")
             if c.strip()]
    assert codes[-1] == "OP_COUNT"
    assert codes[:-1] == ["OP_" + name.upper()
                          for name in bls381_cuda.FIELD_OPS]


def test_field_op_on_the_cpu_runs_the_plain_version(operands):
    xs, ys = operands
    a, b = fq.pack_mont(xs), fq.pack_mont(ys)
    before = (bls381_cuda.field_op.plain_calls, bls381_cuda.field_op.launches)
    assert torch.equal(bls381_cuda.field_op("fq_mul", a, b), fq.mul(a, b))
    assert (bls381_cuda.field_op.plain_calls,
            bls381_cuda.field_op.launches) == (before[0] + 1, before[1])
    with pytest.raises(ValueError):
        bls381_cuda.field_op("fq_mul", a)
    with pytest.raises(ValueError):
        bls381_cuda.field_op("fq2_mul", a, b)


# ---------------------------------------------------------------------------
# tower against the reference's limbs (its own tower suite is kernel-tier)
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name", ["fq12_mul", "fq12_square",
                                  "fq12_cyclotomic_square", "fq12_inv",
                                  "fq12_frobenius"])
def test_tower_equals_the_reference_limb_for_limb(name):
    from consensus_specs_tpu.ops import fq_tower as jft
    rng = random.Random(f"{SEED}-jax-{name}")
    vals = [_fq12(rng) for _ in range(2)]
    ja = jft.fq12_pack_mont(vals)
    a = ft.fq12_pack_mont(vals)
    if name == "fq12_mul":
        got, want = ft.fq12_mul(a, a.flip(0)), jft.fq12_mul(ja, ja[::-1])
    elif name == "fq12_frobenius":
        got, want = ft.fq12_frobenius(a, 3), jft.fq12_frobenius(ja, 3)
    else:
        got, want = getattr(ft, name)(a), getattr(jft, name)(ja)
    assert torch.equal(got, fq_limbs_from_numpy(np.asarray(want)))
