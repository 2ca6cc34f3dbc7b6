"""BLS12-381 tower on torch limbs, Fq2 -> Fq6 -> Fq12 (the plain version).

Counterpart of consensus_specs_tpu/ops/fq_tower.py, with its tower, its
component order and its names (crypto/fields.py is the oracle):

    Fq2  = Fq[u]  / (u^2 + 1)
    Fq6  = Fq2[v] / (v^3 - XI),  XI = u + 1
    Fq12 = Fq6[w] / (w^2 - v)

Layouts (component-major, limbs last, batched over leading axes):
    fq2  : [..., 2, 32]
    fq6  : [..., 6, 32]   components (c0.a, c0.b, c1.a, c1.b, c2.a, c2.b)
    fq12 : [..., 12, 32]  two fq6 halves

As in the reference, every tower multiplication is Karatsuba-decomposed and
its leaf Fq products are stacked into one batched `fq.mul` call, so an fq12
product is one `fq.mul` over 54 rows.  The fixed exponents (q - 2 of the
Fermat inverse, a power's bits) are public, so their zero bits skip the
multiply with a branch instead of a select: the same result.
"""
from __future__ import annotations

import numpy as np
import torch

from ..crypto.fields import Q
from . import fq

# ---------------------------------------------------------------------------
# fq2
# ---------------------------------------------------------------------------


def fq2_add(a, b):
    return fq.add(a, b)


def fq2_sub(a, b):
    return fq.sub(a, b)


def fq2_neg(a):
    return fq.neg(a)


def fq2_conj(a):
    return torch.cat([a[..., 0:1, :], fq.neg(a[..., 1:2, :])], dim=-2)


def fq2_mul(a, b):
    """Karatsuba: 3 stacked Fq products (the sums a0 + a1 and b0 + b1 go
    into the product unreduced)."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    b0, b1 = b[..., 0, :], b[..., 1, :]
    v = fq.mul(torch.stack([a0, a1, a0 + a1], dim=-2),
               torch.stack([b0, b1, b0 + b1], dim=-2))
    v0, v1, v2 = v[..., 0, :], v[..., 1, :], v[..., 2, :]
    d = fq.sub(torch.stack([v0, v2], dim=-2), torch.stack([v1, v0], dim=-2))
    return torch.stack([d[..., 0, :], fq.sub(d[..., 1, :], v1)], dim=-2)


def fq2_square(a):
    """(a0+a1)(a0-a1), 2*a0*a1: 2 stacked Fq products of unreduced sums
    and differences (a0 - a1 raised by 2q, so no limb is negative)."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    diff = a0 - a1 + fq._const(fq.TWO_Q_SPREAD, a)
    return fq.mul(torch.stack([a0 + a1, a0 + a0], dim=-2),
                  torch.stack([diff, a1], dim=-2))


def fq2_mul_xi(a):
    """Multiply by XI = 1 + u: (a0 - a1, a0 + a1)."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    return torch.stack([fq.sub(a0, a1), fq.add(a0, a1)], dim=-2)


def fq2_mul_fq(a, s):
    """fq2 element times an Fq scalar s [..., 32]."""
    return fq.mul(a, torch.stack([s, s], dim=-2))


def fq2_is_zero(a):
    return torch.all(a == 0, dim=-1).all(dim=-1)


def fq2_eq(a, b):
    return torch.all(a == b, dim=-1).all(dim=-1)


def fq2_one(like):
    """1 in Fq2 (Montgomery), broadcast to like's shape [..., 2, 32]."""
    one = torch.stack([fq._const(fq.ONE_MONT_LIMBS, like),
                       fq._const(fq.ZERO_LIMBS, like)])
    return one.expand(like.shape)


# ---------------------------------------------------------------------------
# generic stacked helpers
# ---------------------------------------------------------------------------

def _many(op, lhs, rhs):
    """One batched call of a field op over lists of same-shape operands
    (the plain version pays per call, not per element)."""
    return op(torch.stack(lhs), torch.stack(rhs)).unbind(0)


def _stack2(xs):
    """Stack a list of fq2 values into [..., k, 2, 32]."""
    return torch.stack(xs, dim=-3)


def _fq2_mul_many(pairs):
    """One batched fq2 mul over a list of (a, b) fq2 pairs."""
    a, b = torch.broadcast_tensors(_stack2([p[0] for p in pairs]),
                                   _stack2([p[1] for p in pairs]))
    out = fq2_mul(a, b)
    return [out[..., i, :, :] for i in range(len(pairs))]


# ---------------------------------------------------------------------------
# fq6 (three fq2 coefficients of v^0, v^1, v^2)
# ---------------------------------------------------------------------------

def _fq6_parts(a):
    return a[..., 0:2, :], a[..., 2:4, :], a[..., 4:6, :]


def _fq6_join(c0, c1, c2):
    return torch.cat([c0, c1, c2], dim=-2)


def fq6_add(a, b):
    return fq.add(a, b)


def fq6_sub(a, b):
    return fq.sub(a, b)


def fq6_neg(a):
    return fq.neg(a)


def fq6_mul(a, b):
    """Karatsuba-CH: 6 fq2 products, one stacked call (and one stacked
    call for each level of its sums)."""
    a0, a1, a2 = _fq6_parts(a)
    b0, b1, b2 = _fq6_parts(b)
    s01, s02, s12, t01, t02, t12 = fq.add(
        torch.stack([a0, a0, a1, b0, b0, b1]),
        torch.stack([a1, a2, a2, b1, b2, b2])).unbind(0)
    v0, v1, v2, p01, p02, p12 = _fq2_mul_many([
        (a0, b0), (a1, b1), (a2, b2), (s01, t01), (s02, t02), (s12, t12)])
    u = fq.add(torch.stack([v1, v0, v0]), torch.stack([v2, v1, v2]))
    w = fq.sub(torch.stack([p12, p01, p02]), u)
    x = fq2_mul_xi(torch.stack([w[0], v2]))
    c = fq.add(torch.stack([v0, w[1], w[2]]), torch.stack([x[0], x[1], v1]))
    return _fq6_join(c[0], c[1], c[2])


def fq6_square(a):
    return fq6_mul(a, a)


def fq6_mul_by_v(a):
    """(c0, c1, c2) -> (XI*c2, c0, c1)."""
    c0, c1, c2 = _fq6_parts(a)
    return _fq6_join(fq2_mul_xi(c2), c0, c1)


def fq6_mul_fq2(a, s):
    """fq6 times an fq2 scalar: 3 stacked fq2 products."""
    c0, c1, c2 = _fq6_parts(a)
    r0, r1, r2 = _fq2_mul_many([(c0, s), (c1, s), (c2, s)])
    return _fq6_join(r0, r1, r2)


# ---------------------------------------------------------------------------
# fq12 (two fq6 coefficients of w^0, w^1)
# ---------------------------------------------------------------------------

def _fq12_parts(a):
    return a[..., 0:6, :], a[..., 6:12, :]


def _fq12_join(c0, c1):
    return torch.cat([c0, c1], dim=-2)


def fq12_add(a, b):
    return fq.add(a, b)


def fq12_sub(a, b):
    return fq.sub(a, b)


def fq12_mul(a, b):
    """Karatsuba over fq6: 3 fq6 products as one stacked call."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1 = _fq12_parts(a)
    b0, b1 = _fq12_parts(b)
    s = fq.add(torch.stack([a0, b0]), torch.stack([a1, b1]))
    v = fq6_mul(torch.stack([a0, a1, s[0]], dim=-3),
                torch.stack([b0, b1, s[1]], dim=-3))
    v0, v1, v2 = v[..., 0, :, :], v[..., 1, :, :], v[..., 2, :, :]
    u = fq.add(torch.stack([v0, v0]), torch.stack([fq6_mul_by_v(v1), v1]))
    return _fq12_join(u[0], fq6_sub(v2, u[1]))


def fq12_square(a):
    """2 fq6-mul squaring: t = a0*a1; c0 = (a0+a1)(a0+v*a1) - t - v*t;
    c1 = 2t."""
    a0, a1 = _fq12_parts(a)
    p = fq.add(torch.stack([a0, a0]), torch.stack([a1, fq6_mul_by_v(a1)]))
    v = fq6_mul(torch.stack([a0, p[0]], dim=-3),
                torch.stack([a1, p[1]], dim=-3))
    t, s = v[..., 0, :, :], v[..., 1, :, :]
    u = fq.add(torch.stack([t, t]), torch.stack([fq6_mul_by_v(t), t]))
    return _fq12_join(fq6_sub(s, u[0]), u[1])


def fq12_conj(a):
    """Conjugation f^(q^6): negate the w coefficient.  For unitary f
    (after the easy part) this is the inverse."""
    a0, a1 = _fq12_parts(a)
    return _fq12_join(a0, fq6_neg(a1))


def fq12_one(batch_shape=(), device="cpu"):
    one = torch.zeros(tuple(batch_shape) + (12, fq.LIMBS), dtype=torch.int64,
                      device=device)
    one[..., 0, :] = torch.from_numpy(fq.ONE_MONT_LIMBS).to(device)
    return one


def fq12_is_one(a):
    one = fq12_one(device=a.device)
    return torch.all(a == one, dim=-1).all(dim=-1)


def fq12_select(cond, a, b):
    return torch.where(cond[..., None, None], a, b)


# ---------------------------------------------------------------------------
# frobenius + cyclotomic squaring (final-exponentiation fast path)
# ---------------------------------------------------------------------------

# fq12 layout component j -> basis w^k, k = _FROB_K[j]; frobenius scales
# conj(comp_j) by XI^(k(q-1)/6)
_FROB_K = (0, 2, 4, 1, 3, 5)


def _frob_gamma_limbs() -> np.ndarray:
    # the oracle's table (crypto/fields.py _FROB_GAMMA = XI^(k(q-1)/6)),
    # re-packed into Montgomery limbs: [6, 2, 32]
    from ..crypto.fields import _FROB_GAMMA
    return np.stack([fq.pack_mont([_FROB_GAMMA[k].c0, _FROB_GAMMA[k].c1])
                     .numpy() for k in _FROB_K])


_FROB_GAMMA_LIMBS = _frob_gamma_limbs()


def fq12_frobenius(a, power: int = 1):
    """x -> x^(q^power); one batched fq2 mul per application."""
    out = a
    for _ in range(power):
        v = out.reshape(out.shape[:-2] + (6, 2, fq.LIMBS))
        v = torch.cat([v[..., 0:1, :], fq.neg(v[..., 1:2, :])], dim=-2)
        v = fq2_mul(v, fq._const(_FROB_GAMMA_LIMBS, v).expand(v.shape))
        out = v.reshape(a.shape)
    return out


def fq12_cyclotomic_square(a):
    """Granger-Scott squaring for unitary elements: three Fq4 squarings,
    all nine underlying fq2 squares in one stacked call.  Mirrors
    Fq12.cyclotomic_square and the reference's formula step by step (the
    kernels' field hold feeds it non-unitary elements too):

        (t0, t1) of the pair (za, zb) = (XI*zb^2 + za^2,
                                         (za+zb)^2 - za^2 - zb^2),
        dbl_plus(t, z, -) = 2(t - z) + t,  dbl_plus(t, z, +) = 2(t + z) + t;

    z0, z1 from the pair (z0, z1); z4, z5 from (z2, z3); z2 (with XI*t1)
    and z3 from (z4, z5)."""
    c = a.reshape(a.shape[:-2] + (6, 2, fq.LIMBS))
    z0, z4, z3 = c[..., 0, :, :], c[..., 1, :, :], c[..., 2, :, :]
    z2, z1, z5 = c[..., 3, :, :], c[..., 4, :, :], c[..., 5, :, :]
    za = torch.stack([z0, z2, z4])
    zb = torch.stack([z1, z3, z5])
    s = fq2_square(torch.stack([za, zb, fq2_add(za, zb)]))
    t0 = fq2_add(fq2_mul_xi(s[1]), s[0])           # per pair
    t1 = fq2_sub(fq2_sub(s[2], s[0]), s[1])
    minus_t = t0                                   # -> z0, z4, z3
    plus_t = torch.stack([t1[0], t1[1], fq2_mul_xi(t1[2])])  # -> z1, z5, z2
    base = torch.cat([fq2_sub(minus_t, torch.stack([z0, z4, z3])),
                      fq2_add(plus_t, torch.stack([z1, z5, z2]))])
    tt = torch.cat([minus_t, plus_t])
    r = fq2_add(fq2_add(base, base), tt)
    # r: z0n, z4n, z3n, z1n, z5n, z2n -> layout z0, z4, z3, z2, z1, z5
    return torch.cat([r[0], r[1], r[2], r[5], r[3], r[4]], dim=-2)


# ---------------------------------------------------------------------------
# inversion (tower descent; Fq inverse by fixed-exponent power)
# ---------------------------------------------------------------------------

_QM2_BITS = [int(b) for b in bin(Q - 2)[2:]]  # msb-first


def fq_inv(a):
    """a^(q-2) by square-and-multiply over the fixed exponent (0 -> 0)."""
    acc = a
    for bit in _QM2_BITS[1:]:
        acc = fq.square(acc)
        if bit:
            acc = fq.mul(acc, a)
    return acc


def fq2_inv(a):
    """(a0 - a1 u) / (a0^2 + a1^2)."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    sq = fq.mul(a, a)
    norm = fq.add(sq[..., 0, :], sq[..., 1, :])
    ninv = fq_inv(norm)
    return fq.mul(torch.stack([a0, fq.neg(a1)], dim=-2),
                  torch.stack([ninv, ninv], dim=-2))


def fq6_inv(a):
    a0, a1, a2 = _fq6_parts(a)
    v0, v1, v2, v3, v4, v5 = _fq2_mul_many([
        (a0, a0), (a1, a1), (a2, a2), (a0, a1), (a0, a2), (a1, a2)])
    c0 = fq2_sub(v0, fq2_mul_xi(v5))
    c1 = fq2_sub(fq2_mul_xi(v2), v3)
    c2 = fq2_sub(v1, v4)
    t0, t1, t2 = _fq2_mul_many([(a0, c0), (a2, c1), (a1, c2)])
    norm = fq2_add(t0, fq2_mul_xi(fq2_add(t1, t2)))
    ninv = fq2_inv(norm)
    return fq6_mul_fq2(_fq6_join(c0, c1, c2), ninv)


def fq12_inv(a):
    a0, a1 = _fq12_parts(a)
    sq = fq6_mul(torch.stack([a0, a1], dim=-3), torch.stack([a0, a1], dim=-3))
    t = fq6_sub(sq[..., 0, :, :], fq6_mul_by_v(sq[..., 1, :, :]))
    tinv = fq6_inv(t)
    c = fq6_mul(torch.stack([a0, a1], dim=-3),
                torch.stack([tinv, tinv], dim=-3))
    return _fq12_join(c[..., 0, :, :], fq6_neg(c[..., 1, :, :]))


# ---------------------------------------------------------------------------
# fixed-exponent fq12 power
# ---------------------------------------------------------------------------

def fq12_pow_fixed(a, exponent_bits):
    """a^e for a fixed (host-known) exponent given as msb-first bits."""
    acc = fq12_one(a.shape[:-2], a.device)
    for bit in [int(b) for b in exponent_bits]:
        acc = fq12_square(acc)
        if bit:
            acc = fq12_mul(acc, a)
    return acc


# ---------------------------------------------------------------------------
# host codecs (oracle interop)
# ---------------------------------------------------------------------------

def fq2_pack_mont(vals, device="cpu") -> torch.Tensor:
    """List of oracle Fq2 (crypto.fields.Fq2) -> [n, 2, 32] Montgomery."""
    return fq.pack_mont([c for v in vals for c in (v.c0, v.c1)],
                        device).reshape(len(vals), 2, fq.LIMBS)


def fq2_unpack_mont(arr):
    from ..crypto.fields import Fq2
    c = fq.unpack_mont(torch.as_tensor(arr).reshape(-1, fq.LIMBS))
    return [Fq2(c[2 * i], c[2 * i + 1]) for i in range(len(c) // 2)]


def _fq6_comps(v):
    return [v.c0.c0, v.c0.c1, v.c1.c0, v.c1.c1, v.c2.c0, v.c2.c1]


def fq6_pack_mont(vals, device="cpu") -> torch.Tensor:
    return fq.pack_mont([c for v in vals for c in _fq6_comps(v)],
                        device).reshape(len(vals), 6, fq.LIMBS)


def fq6_unpack_mont(arr):
    from ..crypto.fields import Fq2, Fq6
    c = fq.unpack_mont(torch.as_tensor(arr).reshape(-1, fq.LIMBS))
    return [Fq6(Fq2(c[i], c[i + 1]), Fq2(c[i + 2], c[i + 3]),
                Fq2(c[i + 4], c[i + 5])) for i in range(0, len(c), 6)]


def fq12_pack_mont(vals, device="cpu") -> torch.Tensor:
    return fq.pack_mont(
        [c for v in vals for c in _fq6_comps(v.c0) + _fq6_comps(v.c1)],
        device).reshape(len(vals), 12, fq.LIMBS)


def fq12_unpack_mont(arr):
    from ..crypto.fields import Fq12
    halves = fq6_unpack_mont(torch.as_tensor(arr).reshape(-1, 6, fq.LIMBS))
    return [Fq12(halves[i], halves[i + 1]) for i in range(0, len(halves), 2)]
