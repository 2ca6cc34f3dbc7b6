"""Optimal ate pairing on BLS12-381.

From-scratch implementation over the fields.py tower.  G2 points are
untwisted into E(Fq12) via (x, y) -> (x/w^2, y/w^3) (w^6 = XI, derived from
the tower relations), and the Miller loop runs over the bits of |z| with
line evaluations at the G1 argument.  The final exponentiation uses the
easy (q^6-1)(q^2+1) step then the standard BLS12 x-chain hard part
(cyclotomic squarings + Frobenius maps), computing e(P,Q)^3 uniformly —
sound for every equality/is-one use (see final_exponentiation).

Verified against the production KZG trusted setup: e([tau]G1, G2) ==
e(G1, [tau]G2) for the monomial points (tests/test_bls.py).
"""
from __future__ import annotations

from .fields import Q, R, BLS_X, Fq2, Fq6, Fq12
from .curve import Point, Fq1

# |z| bits for the Miller loop
_ATE_LOOP = abs(BLS_X)

# hard-part exponent (after the easy (q^6-1)(q^2+1) step); the x-chain in
# _hard_part computes exactly m^(3*_HARD_EXP) — cubing is a bijection on the
# order-r target subgroup, so equality/is-one semantics are unchanged as
# long as every pairing goes through the same chain
_HARD_EXP = (Q**4 - Q * Q + 1) // R


def _embed_fq2(a: Fq2) -> Fq12:
    return Fq12(Fq6(a, Fq2.zero(), Fq2.zero()), Fq6.zero())


def _embed_fq(a: int) -> Fq12:
    return Fq12(Fq6(Fq2(a, 0), Fq2.zero(), Fq2.zero()), Fq6.zero())


# w   = (0, 1) in the Fq6 pair basis;  w^2 = v;  v^3 = XI
_W = Fq12(Fq6.zero(), Fq6.one())
_W2_INV = (_W * _W).inv()
_W3_INV = (_W * _W * _W).inv()


class _P12:
    """Affine point over Fq12 (None coords = infinity)."""
    __slots__ = ("x", "y")

    def __init__(self, x: Fq12, y: Fq12):
        self.x = x
        self.y = y


def _untwist(q: Point) -> _P12:
    xa, ya = q.affine()
    return _P12(_embed_fq2(xa) * _W2_INV, _embed_fq2(ya) * _W3_INV)


def _line_eval(t: _P12, u: _P12, xp: Fq12, yp: Fq12) -> Fq12:
    """Evaluate the line through T and U (or tangent at T if T==U) at P."""
    if t.x == u.x and t.y == u.y:
        # tangent: slope = 3x^2 / 2y
        num = t.x.square()
        num = num + num + num
        den = t.y + t.y
    elif t.x == u.x:
        # vertical line
        return xp - t.x
    else:
        num = u.y - t.y
        den = u.x - t.x
    slope = num * den.inv()
    return slope * (xp - t.x) - (yp - t.y)


def _p12_add(a: _P12, b: _P12) -> _P12:
    if a.x == b.x and a.y == b.y:
        num = a.x.square()
        num = num + num + num
        den = a.y + a.y
    elif a.x == b.x:
        raise ZeroDivisionError("vertical addition in miller loop")
    else:
        num = b.y - a.y
        den = b.x - a.x
    s = num * den.inv()
    x3 = s.square() - a.x - b.x
    y3 = s * (a.x - x3) - a.y
    return _P12(x3, y3)


def miller_loop(p: Point, q: Point) -> Fq12:
    """Miller loop value f_{|z|,Q}(P); final exponentiation applied separately."""
    if p.is_infinity() or q.is_infinity():
        return Fq12.one()
    xa, ya = p.affine()
    xp, yp = _embed_fq(xa.v), _embed_fq(ya.v)
    qt = _untwist(q)
    t = _P12(qt.x, qt.y)
    f = Fq12.one()
    for bit in bin(_ATE_LOOP)[3:]:
        f = f.square() * _line_eval(t, t, xp, yp)
        t = _p12_add(t, t)
        if bit == "1":
            f = f * _line_eval(t, qt, xp, yp)
            t = _p12_add(t, qt)
    # z < 0: conjugate (differs from the true inverse by a norm-subfield
    # factor, which the final exponentiation kills)
    return f.conjugate()


def _exp_by_neg_x(m: Fq12) -> Fq12:
    """m^x for the (negative) BLS parameter x, m unitary: square-and-multiply
    by |x| with cyclotomic squarings, then conjugate."""
    acc = m
    for bit in bin(_ATE_LOOP)[3:]:
        acc = acc.cyclotomic_square()
        if bit == "1":
            acc = acc * m
    return acc.conjugate()


def _hard_part(m: Fq12) -> Fq12:
    """m^(3 * (q^4 - q^2 + 1) / r) by the standard BLS12 addition chain
    (5 exp-by-x + 3 Frobenius; verified symbolically in
    tests/test_bls.py::test_hard_part_chain_exponent)."""
    t2 = m
    t1 = t2.cyclotomic_square().conjugate()      # m^-2
    t3 = _exp_by_neg_x(t2)                       # m^x
    t4 = t3.cyclotomic_square()                  # m^2x
    t5 = t1 * t3                                 # m^(x-2)
    t1 = _exp_by_neg_x(t5)                       # m^(x^2-2x)
    t0 = _exp_by_neg_x(t1)                       # m^(x^3-2x^2)
    t6 = _exp_by_neg_x(t0)                       # m^(x^4-2x^3)
    t6 = t6 * t4                                 # m^(x^4-2x^3+2x)
    t4 = _exp_by_neg_x(t6)
    t5 = t5.conjugate()
    t4 = t4 * t5 * t2
    t5 = t2.conjugate()
    t1 = t1 * t2                                 # m^(x^2-2x+1)
    t1 = t1.frobenius(3)
    t6 = t6 * t5
    t6 = t6.frobenius(1)
    t3 = t3 * t0
    t3 = t3.frobenius(2)
    t3 = t3 * t1
    t3 = t3 * t6
    return t3 * t4


def final_exponentiation(f: Fq12) -> Fq12:
    """f^(3 * (q^12 - 1) / r): easy part then the x-chain hard part.

    The extra factor of 3 (inherent to the chain) is harmless: pairing
    values live in the order-r subgroup where cubing is a bijection, so
    e(P,Q)-equality and is-one checks are unaffected.
    """
    f1 = f.conjugate() * f.inv()                 # f^(q^6-1)
    m = f1.frobenius(2) * f1                     # ^(q^2+1): now unitary
    return _hard_part(m)


def pairing(p: Point, q: Point) -> Fq12:
    """e(P, Q) for P in G1, Q in G2."""
    return final_exponentiation(miller_loop(p, q))


def pairing_check(pairs: list[tuple[Point, Point]]) -> bool:
    """prod e(P_i, Q_i) == 1, with a single shared final exponentiation."""
    f = Fq12.one()
    for p, q in pairs:
        f = f * miller_loop(p, q)
    return final_exponentiation(f).is_one()
