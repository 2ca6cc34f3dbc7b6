"""BLS signature suite (proof-of-possession scheme) over BLS12-381.

The native backend behind consensus_specs_tpu_torch.utils.bls — capability
parity with the consensus-specs py_ecc/milagro/arkworks backends
(tests/core/pyspec/eth2spec/utils/bls.py there): minimal
pubkeys in G1, signatures in G2, messages hashed with the
BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_ suite.

Raises ValueError for malformed/invalid inputs (the shim converts those to
False verdicts); programming errors propagate.
"""
from __future__ import annotations

from .fields import R, Fq12
from . import curve as cv
from .curve import Point, DecodeError
from .pairing import pairing_check as _pairing_check, miller_loop, final_exponentiation
from .hash_to_curve import hash_to_g2


def _check_sk(sk: int) -> int:
    sk = int(sk)
    if not 0 < sk < R:
        raise ValueError("secret key out of range")
    return sk


def SkToPk(sk: int) -> bytes:
    return cv.g1_to_bytes(cv.g1_generator() * _check_sk(sk))


def Sign(sk: int, message: bytes) -> bytes:
    return cv.g2_to_bytes(hash_to_g2(message) * _check_sk(sk))


def KeyValidate(pubkey: bytes) -> bool:
    try:
        p = cv.g1_from_bytes(pubkey)
    except DecodeError:
        return False
    return not p.is_infinity()


def _load_pubkey(pubkey: bytes) -> Point:
    p = cv.g1_from_bytes(pubkey)
    if p.is_infinity():
        raise ValueError("infinity pubkey")
    return p


def _load_signature(signature: bytes) -> Point:
    return cv.g2_from_bytes(signature)


def Verify(pubkey: bytes, message: bytes, signature: bytes) -> bool:
    try:
        pk = _load_pubkey(pubkey)
        sig = _load_signature(signature)
    except DecodeError:
        return False
    return _pairing_check([(pk, hash_to_g2(message)), (-cv.g1_generator(), sig)])


def Aggregate(signatures: list[bytes]) -> bytes:
    if not signatures:
        raise ValueError("cannot aggregate empty signature list")
    acc = cv.g2_infinity()
    for s in signatures:
        acc = acc + _load_signature(s)
    return cv.g2_to_bytes(acc)


def AggregatePKs(pubkeys: list[bytes]) -> bytes:
    if not pubkeys:
        raise ValueError("cannot aggregate empty pubkey list")
    acc = cv.g1_infinity()
    for pk in pubkeys:
        acc = acc + _load_pubkey(pk)
    return cv.g1_to_bytes(acc)


def FastAggregateVerify(pubkeys: list[bytes], message: bytes,
                        signature: bytes) -> bool:
    if not pubkeys:
        return False
    try:
        agg = cv.g1_infinity()
        for pk in pubkeys:
            agg = agg + _load_pubkey(pk)
        sig = _load_signature(signature)
    except DecodeError:
        return False
    return _pairing_check([(agg, hash_to_g2(message)),
                           (-cv.g1_generator(), sig)])


def AggregateVerify(pubkeys: list[bytes], messages: list[bytes],
                    signature: bytes) -> bool:
    if not pubkeys or len(pubkeys) != len(messages):
        return False
    try:
        pairs = [(_load_pubkey(pk), hash_to_g2(m))
                 for pk, m in zip(pubkeys, messages)]
        sig = _load_signature(signature)
    except DecodeError:
        return False
    pairs.append((-cv.g1_generator(), sig))
    return _pairing_check(pairs)


# ---------------------------------------------------------------------------
# low-level curve API (for KZG / Whisk, reference bls.py:224-392)
# Points are curve.Point objects; the spec treats them opaquely.
# ---------------------------------------------------------------------------

def add(a: Point, b: Point) -> Point:
    return a + b


def multiply(p: Point, n: int) -> Point:
    return p * int(n)


def neg(p: Point) -> Point:
    return -p


def multi_exp(points: list[Point], scalars: list[int]) -> Point:
    """Multi-scalar multiplication (naive; Pippenger on TPU is ops/msm)."""
    if not points or len(points) != len(scalars):
        raise ValueError("multi_exp: bad lengths")
    acc = Point.infinity(points[0].b)
    for p, s in zip(points, scalars):
        acc = acc + p * int(s)
    return acc


def pairing_check(values: list[tuple[Point, Point]]) -> bool:
    return _pairing_check(values)


def Z1() -> Point:
    return cv.g1_infinity()


def Z2() -> Point:
    return cv.g2_infinity()


def G1() -> Point:
    return cv.g1_generator()


def G2() -> Point:
    return cv.g2_generator()


def G1_to_bytes48(p: Point) -> bytes:
    return cv.g1_to_bytes(p)


def bytes48_to_G1(b: bytes) -> Point:
    return cv.g1_from_bytes(b, subgroup_check=False)


def G2_to_bytes96(p: Point) -> bytes:
    return cv.g2_to_bytes(p)


def bytes96_to_G2(b: bytes) -> Point:
    return cv.g2_from_bytes(b, subgroup_check=False)
