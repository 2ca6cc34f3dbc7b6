"""G1/G2 Jacobian point arithmetic on torch limbs (plain version).

Counterpart of consensus_specs_tpu/ops/curve_jax.py: one generic Jacobian
implementation (a = 0 short Weierstrass) over the Fq (G1) and Fq2 (G2) limb
fields of ops/fq.py and ops/fq_tower.py.  Points are (X, Y, Z) limb tensors
batched over leading axes; infinity is Z = 0 (X = Y = 1, Montgomery).

Formulas: dbl-2009-l and add-2007-bl (hyperelliptic.org EFD), complete
through selects over the identity, equal and negated inputs, as in the
reference: the Jacobian coordinates they leave are part of the result (the
ladder kernel must equal them bit for bit).  The field ops of each formula
level are stacked into one batched call (the plain version on the CPU pays
per call, not per element); the values are the reference's.

`g2_scalar_mul` is the entry point of the G2 ladder: on a CUDA tensor it
launches ops/csrc/bls381_g2.cu (ops/bls381_cuda.py), on a CPU tensor it
runs `point_scalar_mul` here.  `clear_cofactor_g2_plain` is the plain
version of ops/csrc/bls381_cofactor.cu: h_eff P by the psi endomorphism
(RFC 9380 G.3), affine.

Oracle: crypto/curve.py (the same group, other formulas: compare points,
not coordinates).
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..crypto import curve as cv
from ..crypto.fields import BLS_X, Q, Fq2
from . import fq
from . import fq_tower as ft

# ---------------------------------------------------------------------------
# field op tables
# ---------------------------------------------------------------------------

F1 = SimpleNamespace(
    add=fq.add, sub=fq.sub, neg=fq.neg, mul=fq.mul, square=fq.square,
    is_zero=fq.is_zero, eq=fq.eq,
    select=fq.select,
    zero_like=fq.zeros_like,
    one_like=fq.one_mont,
    comp_axes=(-1,),
)

F2 = SimpleNamespace(
    add=ft.fq2_add, sub=ft.fq2_sub, neg=ft.fq2_neg, mul=ft.fq2_mul,
    square=ft.fq2_square, is_zero=ft.fq2_is_zero, eq=ft.fq2_eq,
    select=lambda c, a, b: torch.where(c[..., None, None], a, b),
    zero_like=torch.zeros_like,
    one_like=ft.fq2_one,
    comp_axes=(-2, -1),
)


# ---------------------------------------------------------------------------
# generic Jacobian ops
# ---------------------------------------------------------------------------

def point_infinity_like(F, pt):
    X, Y, Z = pt
    return (F.one_like(X), F.one_like(Y), F.zero_like(Z))


def point_is_infinity(F, pt):
    return F.is_zero(pt[2])


def point_double(F, pt):
    """dbl-2009-l: A = X^2, B = Y^2, C = B^2, D = 2((X+B)^2 - A - C),
    E = 3A, X3 = E^2 - 2D, Y3 = E(D - X3) - 8C, Z3 = 2YZ; each level's
    independent field ops run as one stacked call."""
    X, Y, Z = pt
    A, B, YZ = ft._many(F.mul, [X, Y, Y], [X, Y, Z])
    XB = F.add(X, B)
    C, t = ft._many(F.mul, [B, XB], [B, XB])
    A2, C2, Z3, AC = ft._many(F.add, [A, C, YZ, A], [A, C, YZ, C])
    E, C4 = ft._many(F.add, [A, C2], [A2, C2])
    D = F.sub(t, AC)
    D, C8 = ft._many(F.add, [D, C4], [D, C4])
    Fv = F.mul(E, E)
    X3 = F.sub(Fv, F.add(D, D))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
    return (X3, Y3, Z3)


def point_add(F, p1, p2):
    """Complete addition (add-2007-bl) via select over {add, double,
    identity} cases; each level's independent field ops run as one
    stacked call, and the doubling is computed only when some row needs
    it (the select would discard it otherwise)."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    Z1Z1, Z2Z2, Y1Z2, Y2Z1 = ft._many(F.mul, [Z1, Z2, Y1, Y2],
                                      [Z1, Z2, Z2, Z1])
    U1, U2, S1, S2 = ft._many(F.mul, [X1, X2, Y1Z2, Y2Z1],
                           [Z2Z2, Z1Z1, Z2Z2, Z1Z1])
    H, rr = ft._many(F.sub, [U2, S2], [U1, S1])
    r, H2, Zsum, ZZ = ft._many(F.add, [rr, H, Z1, Z1Z1], [rr, H, Z2, Z2Z2])
    I, r2, Zs = ft._many(F.mul, [H2, r, Zsum], [H2, r, Zsum])   # I = (2H)^2
    J, V = ft._many(F.mul, [H, U1], [I, I])
    VV = F.add(V, V)
    rJ, Zd = ft._many(F.sub, [r2, Zs], [J, ZZ])
    X3 = F.sub(rJ, VV)
    rVX, S1J, Z3 = ft._many(F.mul, [r, S1, Zd], [F.sub(V, X3), J, H])
    Y3 = F.sub(rVX, F.add(S1J, S1J))
    out = (X3, Y3, Z3)

    inf1 = point_is_infinity(F, p1)
    inf2 = point_is_infinity(F, p2)
    h_zero = F.is_zero(H)
    r_zero = F.is_zero(r)
    same_point = h_zero & r_zero & ~inf1 & ~inf2     # P == Q: double
    opposite = h_zero & ~r_zero & ~inf1 & ~inf2      # P == -Q: infinity
    if bool(same_point.any()):
        doubled = point_double(F, p1)
        out = tuple(F.select(same_point, d, o) for d, o in zip(doubled, out))
    inf_pt = point_infinity_like(F, p1)
    out = tuple(F.select(opposite, i, o) for i, o in zip(inf_pt, out))
    out = tuple(F.select(inf1, b, o) for b, o in zip(p2, out))
    out = tuple(F.select(inf2, a, o) for a, o in zip(p1, out))
    return out


def point_neg(F, pt):
    return (pt[0], F.neg(pt[1]), pt[2])


def point_scalar_mul(F, pt, scalar_bits):
    """Double-and-add over an msb-first bit tensor [..., n_bits] (batched).
    A bit column that is zero in every row skips the add (the select would
    keep the doubled point anyway)."""
    acc = point_infinity_like(F, pt)
    bits = torch.as_tensor(scalar_bits).to(torch.bool)
    if bits.device != pt[0].device:
        bits = bits.to(pt[0].device)
    col_any = bits.reshape(-1, bits.shape[-1]).any(dim=0).tolist()
    for i, live in enumerate(col_any):
        acc = point_double(F, acc)
        if live:
            added = point_add(F, acc, pt)
            acc = tuple(F.select(bits[..., i], a, o)
                        for a, o in zip(added, acc))
    return acc


def point_sum_tree(F, pts):
    """Reduce points stacked on axis 0 ([n, ...]) by pairwise tree adds."""
    X, Y, Z = pts
    n = X.shape[0]
    m = 1 << (n - 1).bit_length() if n > 1 else 1
    if m != n:
        pad = point_infinity_like(F, (X[:m - n], Y[:m - n], Z[:m - n]))
        X, Y, Z = (torch.cat([c, p], dim=0) for c, p in zip((X, Y, Z), pad))
    while X.shape[0] > 1:
        h = X.shape[0] // 2
        X, Y, Z = point_add(F, (X[:h], Y[:h], Z[:h]), (X[h:], Y[h:], Z[h:]))
    return (X[0], Y[0], Z[0])


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def g1_add(p, q):
    return point_add(F1, p, q)


def g1_double(p):
    return point_double(F1, p)


def g1_scalar_mul(p, bits):
    return point_scalar_mul(F1, p, bits)


def g1_sum(p):
    return point_sum_tree(F1, p)


def g2_add(p, q):
    return point_add(F2, p, q)


def g2_double(p):
    return point_double(F2, p)


def g2_scalar_mul(p, bits):
    """The G2 ladder: the kernel on a CUDA tensor, the plain version on a
    CPU tensor (ops/bls381_cuda.py g2_ladder)."""
    from . import bls381_cuda
    return bls381_cuda.g2_ladder(p, bits)


# ---------------------------------------------------------------------------
# G2 cofactor clearing by psi (plain version of csrc/bls381_cofactor.cu)
# ---------------------------------------------------------------------------

# |x| msb-first, its leading one included (64 bits, 6 ones)
_X_ABS_BITS = tuple(int(b) for b in bin(-BLS_X)[2:])
_PSI_CONSTS: dict = {}      # device -> (c_x, c_y) limbs, once a device


def psi_consts(device="cpu"):
    """psi's constants c_x = (1 + u)^-((q-1)/3), c_y = (1 + u)^-((q-1)/2)
    as Fq2 Montgomery limbs [2, 2, 32] on `device`, from crypto.fields."""
    key = str(torch.device(device))
    if key not in _PSI_CONSTS:
        xi = Fq2(1, 1)
        _PSI_CONSTS[key] = ft.fq2_pack_mont(
            [xi.pow((Q - 1) // 3).inv(), xi.pow((Q - 1) // 2).inv()], device)
    return _PSI_CONSTS[key]


def point_psi(pt, consts):
    """psi on Jacobian G2 limbs: (conj(X) c_x, conj(Y) c_y, conj(Z))."""
    X, Y, Z = pt
    return (ft.fq2_mul(ft.fq2_conj(X), consts[0].expand_as(X)),
            ft.fq2_mul(ft.fq2_conj(Y), consts[1].expand_as(Y)),
            ft.fq2_conj(Z))


def _mul_by_x(pt):
    """[x] P for the negative BLS parameter x: the ladder over |x|, then
    negate."""
    bits = torch.tensor(_X_ABS_BITS, dtype=torch.uint8,
                        device=pt[0].device).expand(pt[0].shape[0], -1)
    return point_neg(F2, point_scalar_mul(F2, pt, bits))


def clear_cofactor_g2_plain(pt):
    """h_eff P for Jacobian G2 limbs (X, Y, Z) [n, 2, 32], affine: (x, y)
    [n, 2, 32] (zeros at infinity) and inf bool [n].  RFC 9380 G.3's steps:
    t1 = [x] P, t2 = psi(P), t3 = psi^2(2P) - t2, t2 = [x](t1 + t2),
    h_eff P = t3 + t2 - t1 - P."""
    consts = psi_consts(pt[0].device)
    t1 = _mul_by_x(pt)
    t2 = point_psi(pt, consts)
    t3 = point_psi(point_psi(point_double(F2, pt), consts), consts)
    t3 = point_add(F2, t3, point_neg(F2, t2))
    t2 = _mul_by_x(point_add(F2, t1, t2))
    t3 = point_add(F2, t3, t2)
    t3 = point_add(F2, t3, point_neg(F2, t1))
    out = point_add(F2, t3, point_neg(F2, pt))
    from .pairing_torch import _g2_jacobian_to_affine
    zero = torch.zeros_like(out[0][0])
    return _g2_jacobian_to_affine(out, zero, zero)


# ---------------------------------------------------------------------------
# host codecs (oracle interop); scalars -> bit tensors
# ---------------------------------------------------------------------------

def scalars_to_bits(scalars, n_bits: int = 256, device="cpu") -> torch.Tensor:
    """msb-first bits [n, n_bits] (uint8) of each scalar mod 2^n_bits."""
    n_bytes = (n_bits + 7) // 8
    mask = (1 << n_bits) - 1
    raw = b"".join((int(s) & mask).to_bytes(n_bytes, "big") for s in scalars)
    bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8))
    bits = bits.reshape(len(scalars), 8 * n_bytes)[:, 8 * n_bytes - n_bits:]
    return torch.from_numpy(np.ascontiguousarray(bits)).to(device)


def g1_pack(points, device="cpu") -> tuple:
    """List of oracle G1 Points -> Jacobian limb tensors [n, 32] (Mont)."""
    return tuple(fq.pack_mont([getattr(p, c).v for p in points], device)
                 for c in "xyz")


def g1_unpack(pt) -> list:
    X, Y, Z = (fq.unpack_mont(c) for c in pt)
    return [cv.Point(cv.Fq1(x), cv.Fq1(y), cv.Fq1(z), cv.B1)
            for x, y, z in zip(X, Y, Z)]


def g2_pack(points, device="cpu") -> tuple:
    return tuple(ft.fq2_pack_mont([getattr(p, c) for p in points], device)
                 for c in "xyz")


def g2_unpack(pt) -> list:
    X, Y, Z = (ft.fq2_unpack_mont(c) for c in pt)
    return [cv.Point(x, y, z, cv.B2) for x, y, z in zip(X, Y, Z)]
