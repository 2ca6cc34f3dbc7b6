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
runs `windowed_ladder` here.  `windowed_ladder` and `glv_ladder` (over
`glv_split` rows) are the plain versions of the kernels' windowed body,
ops/csrc/bls381_ladder.cuh; `point_scalar_mul`, the bit-by-bit ladder, is
the plain version of bls381.cuh `pt_ladder` (K4's legs).
`clear_cofactor_g2_plain` is the plain version of
ops/csrc/bls381_cofactor.cu: h_eff P by the psi endomorphism (RFC 9380
G.3), affine.

Oracle: crypto/curve.py (the same group, other formulas: compare points,
not coordinates).
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..crypto import curve as cv
from ..crypto.fields import BLS_X, Q, R, Fq2
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


# ---------------------------------------------------------------------------
# the windowed ladder and the GLV split (plain versions of
# csrc/bls381_ladder.cuh, the body of K2 and the G2 ladder)
# ---------------------------------------------------------------------------

LADDER_W = 5                    # csrc/bls381_ladder.cuh LADDER_W
GLV_BITS = 128                  # LADDER_SPLIT_BITS: bits of each half
# phi(x, y) = (beta x, y) acts on G1 as [lambda], lambda = x^2 - 1
GLV_LAMBDA = BLS_X * BLS_X - 1
GLV_BETA = pow(pow(2, (Q - 1) // 3, Q), 2, Q)


def glv_split(s):
    """(s0, s1) with s0 + s1 * lambda = s mod r and 0 <= s0, s1 < 2^128:
    s reduced mod r, then s0 = s mod lambda, s1 = s div lambda."""
    return divmod(int(s) % R, GLV_LAMBDA)[::-1]


def glv_bits(scalars, device="cpu") -> torch.Tensor:
    """Split rows [n, 2, GLV_BITS] (uint8, msb first) of the scalars:
    row i holds the bits of s0, then of s1 (`glv_split`)."""
    halves = [h for s in scalars for h in glv_split(s)]
    return scalars_to_bits(halves, GLV_BITS, device).reshape(
        len(scalars), 2, GLV_BITS)


def ladder_digits(bits, w: int = LADDER_W):
    """The regular signed digits of msb-first bit rows [n, nbits]:
    (digits int64 [n, m], the most significant window first, and even bool
    [n]).  Each digit is odd with |d| < 2^w and sum_j d_j 2^(w (m-1-j)) =
    s | 1; `even` marks the rows where s is even (bit 0 forced to one),
    whose ladder subtracts P at the end.  The kernel's `ladder_digit`: a
    window's bits with its lowest forced to one, less 2^w where the next
    more significant window's lowest bit is zero."""
    b = torch.as_tensor(bits).to(torch.int64)
    n, nbits = b.shape
    m = max(1, -(-nbits // w))
    b = torch.nn.functional.pad(b, (m * w - nbits, 0)).reshape(n, m, w)
    low = b[:, :, -1].clone()
    b[:, :, -1] = 1
    v = (b << torch.arange(w - 1, -1, -1, device=b.device)).sum(-1)
    upper = torch.cat([torch.ones_like(low[:, :1]), low[:, :-1]], dim=1)
    return torch.where(upper == 1, v, v - (1 << w)), low[:, -1] == 0


def ladder_table(F, pt, w: int = LADDER_W):
    """The odd multiples P, 3P, ..., (2^w - 1)P of each point, (X, Y, Z)
    each [n, 2^(w-1), ...], by the kernel's levels: 2P = 2 P; at level
    j > 1, (2^(j-1) + k)P = 2^(j-1)P + kP for odd k < 2^(j-1) and, below
    the last, 2^j P = 2 (2^(j-1) P); each level's adds as one call."""
    odd = [pt]
    even = point_double(F, pt)
    for level in range(2, w + 1):
        k = len(odd)
        e = tuple(c.unsqueeze(0).expand((k,) + c.shape) for c in even)
        sums = point_add(F, tuple(c.flatten(0, 1) for c in e),
                         tuple(torch.cat(c) for c in zip(*odd)))
        odd += [tuple(c.unflatten(0, (k, -1))[i] for c in sums)
                for i in range(k)]
        if level < w:
            even = point_double(F, even)
    return tuple(torch.stack(c, dim=1) for c in zip(*odd))


def ladder_chain(F, table, bits, w: int = LADDER_W):
    """s P of each row over its table of odd multiples (`ladder_table`,
    P = table[:, 0]) and its msb-first bit row: the top digit's entry,
    then per window w doublings and one add of the entry, its Y negated
    where the digit is negative; even rows ran as s + 1, and a select
    keeps the sum with -P.  The kernel's `ladder_chain`."""
    digits, even = ladder_digits(bits, w)
    rows = torch.arange(digits.shape[0], device=digits.device)

    def entry(d):
        e = tuple(c[rows, d.abs() >> 1] for c in table)
        return (e[0], F.select(d < 0, F.neg(e[1]), e[1]), e[2])
    acc = entry(digits[:, 0])
    for j in range(1, digits.shape[1]):
        for _ in range(w):
            acc = point_double(F, acc)
        acc = point_add(F, acc, entry(digits[:, j]))
    p = tuple(c[:, 0] for c in table)
    fixed = point_add(F, acc, point_neg(F, p))
    return tuple(F.select(even, f, a) for f, a in zip(fixed, acc))


def windowed_ladder(F, pt, bits):
    """Plain version of the windowed ladder (the G2 ladder and unsplit K2
    rows): s P of each Jacobian point over its msb-first bit row [n,
    nbits], equal to the kernel's words bit for bit."""
    bits = torch.as_tensor(bits)
    if bits.device != pt[0].device:
        bits = bits.to(pt[0].device)
    return ladder_chain(F, ladder_table(F, pt), bits)


def point_phi(pt):
    """phi on Jacobian G1 limbs: (beta X, Y, Z), [lambda] P on G1."""
    X, Y, Z = pt
    beta = fq.pack_mont([GLV_BETA], X.device)[0]
    return (fq.mul(X, beta.expand_as(X)), Y, Z)


def glv_ladder(pt, halves):
    """Plain version of K2's split rows: s P = s0 P + s1 phi(P) for G1
    points in the r-torsion subgroup, halves [n, 2, GLV_BITS] (`glv_bits`):
    one table of P's odd multiples and phi of it, the two chains as one
    call over 2n rows, then one add, s0 P + s1 phi(P)."""
    halves = torch.as_tensor(halves)
    if halves.device != pt[0].device:
        halves = halves.to(pt[0].device)
    table = ladder_table(F1, pt)
    both = tuple(torch.cat([c, p]) for c, p in zip(table, point_phi(table)))
    acc = ladder_chain(F1, both, torch.cat([halves[:, 0], halves[:, 1]]))
    n = pt[0].shape[0]
    return point_add(F1, tuple(c[:n] for c in acc),
                     tuple(c[n:] for c in acc))


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
