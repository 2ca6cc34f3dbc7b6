"""Optimal ate pairing on BLS12-381 over torch limbs, batched (plain version).

Counterpart of consensus_specs_tpu/ops/pairing_jax.py in its fused
formulation (`_pairing_check_fused`): the Miller loop over the bits of |x|
with the twist trick (Q stays on the M-twist E'(Fq2); lines through the
untwisted points, evaluated at P and scaled by w^3 and an Fq2 denominator,
land in the sparse form c0 + c1*v + c4*vw), the product over each job's
pairs, the easy part of the final exponentiation (conjugate times inverse,
then Frobenius^2) and the BLS12 x-chain hard part with cyclotomic squarings.
The line scalings and the chain's order are the reference's: they set the
Miller product's value, which the kernel must equal bit for bit (the field
ops of a step's formula level run as one stacked call; the values are the
reference's).  The zero bits of |x| skip the add step with a branch (the
reference's scan computes it and discards it under a select: the same
result).

`pairing_check`, `miller_partial_products`, `fq12_product_is_one` and
`fold_partial_products` are the entry points.  They go through
ops/bls381_cuda.py, which on CUDA tensors launches ops/csrc/bls381_check.cu
for `pairing_check` (one launch, four warps a job; plain version
`check_plain`) and the pairing's two launches for the others (launch 1: a
pair's Miller loop, four warps a pair; launch 2: a job's product and final
exponentiation, four warps a job; both in the same file, on the check's
levels, bodies ops/csrc/bls381_pairing.cuh),
for the fold first ops/csrc/bls381_fold.cu with a segment sum of
ops/csrc/bls381_check.cu, and runs the plain functions here on CPU
tensors.  The reference's chunked mode, row buckets and `warmup` are XLA
compile and dispatch concerns with no counterpart.  Its `PAIRING_MODE` stays
as the switch the signature pipeline reads (sigpipe/fold.py
`one_launch_live`): "fused", the default, takes the one-launch fold,
"staged" the staged fold chain.

Oracle: crypto/pairing.py (affine untwist into Fq12; its Miller values
differ from these by factors the final exponentiation kills, so verdicts
and final values agree, Miller products do not).
"""
from __future__ import annotations

import os as _os

import torch

from . import fq
from . import fq_tower as ft

# the reference's pairing mode switch: "fused" (the default) or "staged".
# Read by sigpipe/fold.py `one_launch_live` only; the env var is read at
# resolve time, direct assignment wins, reset_mode() forgets a cached
# choice.
PAIRING_MODE = None


def reset_mode() -> None:
    """Forget the cached mode: the next resolve re-reads PAIRING_MODE."""
    global PAIRING_MODE
    PAIRING_MODE = None


def _resolve_mode() -> str:
    global PAIRING_MODE
    if PAIRING_MODE is None:
        PAIRING_MODE = _os.environ.get("PAIRING_MODE") or "fused"
    return PAIRING_MODE

BLS_X_ABS = 0xD201000000010000          # |x|, x negative for BLS12-381

# Miller-loop / exp-by-x bit sequence: bits of |x| msb-first, skipping the
# leading 1
MILLER_BITS = tuple(int(b) for b in bin(BLS_X_ABS)[3:])


# ---------------------------------------------------------------------------
# sparse line -> fq12 embedding
# ---------------------------------------------------------------------------

def _line_to_fq12(c0, c1, c4):
    """Line c0 + c1*v + c4*vw as a full fq12 tensor.

    fq12 component order: [c0.a, c0.b, (v) a, b, (v^2) a, b,
                           (w) a, b, (vw) a, b, (v^2 w) a, b].
    """
    zeros = torch.zeros_like(c0)
    return torch.cat([c0, c1, zeros, zeros, c4, zeros], dim=-2)


# ---------------------------------------------------------------------------
# Miller loop steps (twist-point Jacobian, line coefficients in fq2)
# ---------------------------------------------------------------------------

def _double_step(T, xp, yp):
    """Tangent line at T evaluated at P=(xp, yp), plus T <- 2T.

    Line (scaled by w^3 and 2YZ^3): c0 = 3X^3 - 2Y^2, c1 = -3X^2 Z^2 xp,
    c4 = 2 Y Z^3 yp; then dbl-2009-l (a = 0).  Each level's independent
    field ops run as one stacked call.
    """
    X, Y, Z = T
    mul, add, sub = ft.fq2_mul, ft.fq2_add, ft.fq2_sub
    X2, Y2, Z2, YZ = ft._many(mul, [X, Y, Z, Y], [X, Y, Z, Z])
    XB = add(X, Y2)
    X3, Z3, X2Z2, C, t = ft._many(mul, [X, Z, X2, Y2, XB],
                                  [X2, Z2, Z2, Y2, XB])
    X3x2, Y2x2, X2Z2x2, X2x2, C2, Zn, X2C = ft._many(
        add, [X3, Y2, X2Z2, X2, C, YZ, X2], [X3, Y2, X2Z2, X2, C, YZ, C])
    threeX3, threeX2Z2, E, C4 = ft._many(add, [X3, X2Z2, X2, C2],
                                      [X3x2, X2Z2x2, X2x2, C2])
    c0, D = ft._many(sub, [threeX3, t], [Y2x2, X2C])
    YZ3, Fv = ft._many(mul, [Y, E], [Z3, E])
    D, C8, YZ3x2 = ft._many(add, [D, C4, YZ3], [D, C4, YZ3])
    c1n, c4 = fq.mul(torch.stack([threeX2Z2, YZ3x2]),
                     torch.stack([xp, yp])[..., None, :]).unbind(0)
    c1 = ft.fq2_neg(c1n)
    Xn = sub(Fv, add(D, D))
    Yn = sub(mul(E, sub(D, Xn)), C8)
    return (Xn, Yn, Zn), (c0, c1, c4)


def _add_step(T, Qa, xp, yp):
    """Line through T and the affine twist point Qa=(x2,y2) at P, plus
    T <- T+Q.

    With theta = Y1 - y2 Z1^3 and lam = X1 - x2 Z1^2 (scaled by Z1*lam):
    c0 = theta*x2 - y2*Z1*lam, c1 = -theta*xp, c4 = Z1*lam*yp; then
    madd-2007-bl (mixed addition, a = 0).
    """
    X1, Y1, Z1 = T
    x2, y2 = Qa
    mul, add, sub = ft.fq2_mul, ft.fq2_add, ft.fq2_sub
    Z1Z1 = ft.fq2_square(Z1)
    U2, Z1c = ft._many(mul, [x2, Z1], [Z1Z1, Z1Z1])
    S2 = mul(y2, Z1c)
    theta, lam = ft._many(sub, [Y1, X1], [S2, U2])
    Z1lam = mul(Z1, lam)
    tx2, yZl = ft._many(mul, [theta, y2], [x2, Z1lam])
    c0 = sub(tx2, yZl)
    ctheta, c4 = fq.mul(torch.stack([theta, Z1lam]),
                        torch.stack([xp, yp])[..., None, :]).unbind(0)
    c1 = ft.fq2_neg(ctheta)

    H = ft.fq2_neg(lam)                      # U2 - X1
    HH = ft.fq2_square(H)
    I = add(HH, HH)
    I = add(I, I)
    J = mul(H, I)
    r = ft.fq2_neg(theta)                    # S2 - Y1
    r = add(r, r)
    V = mul(X1, I)
    Xn = sub(sub(ft.fq2_square(r), J), add(V, V))
    YJ = mul(Y1, J)
    Yn = sub(mul(r, sub(V, Xn)), add(YJ, YJ))
    Zn = mul(Z1, H)
    Zn = add(Zn, Zn)                         # madd-2007-bl: Z3 = 2*Z1*H
    return (Xn, Yn, Zn), (c0, c1, c4)


def miller_loop(xp, yp, xq, yq, skip=None):
    """Batched Miller loop: P = (xp, yp) [..., 32], Q = (xq, yq)
    [..., 2, 32] affine, Montgomery.  Returns f in Fq12 [..., 12, 32],
    conjugated for x < 0, and one where `skip` (bool [...]) is set: how
    infinity enters, since e(O, Q) = e(P, O) = 1."""
    T = (xq, yq, ft.fq2_one(xq))
    f = ft.fq12_one(xp.shape[:-1], xp.device)
    for bit in MILLER_BITS:
        T, (c0, c1, c4) = _double_step(T, xp, yp)
        f = ft.fq12_mul(ft.fq12_square(f), _line_to_fq12(c0, c1, c4))
        if bit:
            T, (c0, c1, c4) = _add_step(T, (xq, yq), xp, yp)
            f = ft.fq12_mul(f, _line_to_fq12(c0, c1, c4))
    f = ft.fq12_conj(f)
    if skip is not None:
        f = ft.fq12_select(skip, ft.fq12_one(f.shape[:-2], f.device), f)
    return f


def _prod_reduce_raw(f):
    """Fq12 product over the pairs axis: [..., k, 12, 32] -> [..., 12, 32]."""
    out = f[..., 0, :, :]
    for i in range(1, f.shape[-3]):
        out = ft.fq12_mul(out, f[..., i, :, :])
    return out


def _easy_part(f):
    """f^((q^6-1)(q^2+1)): lands in the cyclotomic subgroup."""
    f1 = ft.fq12_mul(ft.fq12_conj(f), ft.fq12_inv(f))   # f^(q^6-1)
    return ft.fq12_mul(ft.fq12_frobenius(f1, 2), f1)


def _exp_by_neg_x(m):
    """m^x for the negative BLS parameter x, m unitary: square-and-multiply
    by |x| with cyclotomic squarings, then conjugate."""
    acc = m
    for bit in MILLER_BITS:
        acc = ft.fq12_cyclotomic_square(acc)
        if bit:
            acc = ft.fq12_mul(acc, m)
    return ft.fq12_conj(acc)


def _hard_chain(m):
    """The BLS12 x-chain hard part: m^(3(q^4-q^2+1)/r), in the reference's
    order (and the oracle's, crypto/pairing.py `_hard_part`)."""
    cyc, mul, conj = ft.fq12_cyclotomic_square, ft.fq12_mul, ft.fq12_conj
    frob, expx = ft.fq12_frobenius, _exp_by_neg_x
    t2 = m
    t1 = conj(cyc(t2))                  # m^-2
    t3 = expx(t2)                       # m^x
    t4 = cyc(t3)                        # m^2x
    t5 = mul(t1, t3)                    # m^(x-2)
    t1 = expx(t5)                       # m^(x^2-2x)
    t0 = expx(t1)                       # m^(x^3-2x^2)
    t6 = expx(t0)                       # m^(x^4-2x^3)
    t6 = mul(t6, t4)                    # m^(x^4-2x^3+2x)
    t4 = expx(t6)
    t5 = conj(t5)
    t4 = mul(mul(t4, t5), t2)
    t5 = conj(t2)
    t1 = mul(t1, t2)                    # m^(x^2-2x+1)
    t1 = frob(t1, 3)
    t6 = mul(t6, t5)
    t6 = frob(t6, 1)
    t3 = mul(t3, t0)
    t3 = frob(t3, 2)
    t3 = mul(t3, t1)
    t3 = mul(t3, t6)
    return mul(t3, t4)


def final_exponentiation(f):
    """f^(3(q^12-1)/r): the easy part, then the hard chain."""
    return _hard_chain(_easy_part(f))


def product_final(f, final: bool = True):
    """Plain version of the kernel's launch 2: the Fq12 product over each
    job's pairs, f [b, k, 12, 32] -> (product [b, 12, 32], is_one [b]);
    is_one is that of the final exponentiation's value when `final`, else
    None."""
    prod = _prod_reduce_raw(f)
    if not final:
        return prod, None
    return prod, ft.fq12_is_one(final_exponentiation(prod))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _miller_values(xps, yps, xqs, yqs, skip):
    """Launch 1 over the flattened pairs: f [b, k, 12, 32] for b jobs of k
    pairs (the leading axes of xps [..., k, 32] flattened to b)."""
    from . import bls381_cuda
    k = xps.shape[-2]
    n = xps[..., 0].numel()
    if skip is None:
        skip = torch.zeros(xps.shape[:-1], dtype=torch.bool,
                           device=xps.device)
    f = bls381_cuda.miller(
        xps.reshape(n, fq.LIMBS), yps.reshape(n, fq.LIMBS),
        xqs.reshape(n, 2, fq.LIMBS), yqs.reshape(n, 2, fq.LIMBS),
        skip.reshape(n).to(torch.bool))
    return f.reshape(n // k if k else 0, k, 12, fq.LIMBS)


def miller_partial_products(xps, yps, xqs, yqs, skip):
    """Fq12 Miller product over the trailing pairs axis, no final
    exponentiation: xps [..., k, 32] (G2 and skip shapes as in
    pairing_check) -> [..., 12, 32]."""
    from . import bls381_cuda
    f = _miller_values(xps, yps, xqs, yqs, skip)
    prod, _ = bls381_cuda.product_final(f, final=False)
    return prod.reshape(xps.shape[:-2] + (12, fq.LIMBS))


def fq12_product_is_one(partials):
    """prod_i partials[i] == 1 after the final exponentiation: partials
    [n, 12, 32] -> bool (one launch 2 over a single job of n factors)."""
    from . import bls381_cuda
    _, ok = bls381_cuda.product_final(partials[None], final=True)
    return bool(ok[0])


def check_plain(xp, yp, xq, yq, skip):
    """Plain version of bls381_cuda.pairing_check (csrc/bls381_check.cu):
    b jobs of k pairs ([b, k, ...] inputs), one Miller accumulator a job,
    f <- f^2 prod_i l_i over its live pairs at each bit, conjugated at the
    end, then the final exponentiation.  Returns (f [b, 12, 32], ok bool
    [b]); f equals `product_final(miller_loop(...))`'s product: Fq12 is
    commutative and conjugation a ring automorphism."""
    b, k = xp.shape[:2]
    one = ft.fq12_one((b, k), xp.device)
    T = (xq, yq, ft.fq2_one(xq))
    f = ft.fq12_one((b,), xp.device)

    def times_lines(f, lines):
        # the live pairs' lines (one for a skipped pair), multiplied by
        # halving over the pairs axis, then into f
        L = ft.fq12_select(skip, one, _line_to_fq12(*lines))
        while L.shape[1] > 1:
            if L.shape[1] % 2:
                L = torch.cat([L, one[:, :1]], dim=1)
            L = ft.fq12_mul(L[:, 0::2], L[:, 1::2])
        return ft.fq12_mul(f, L[:, 0])
    for bit in MILLER_BITS:
        T, lines = _double_step(T, xp, yp)
        f = times_lines(ft.fq12_square(f), lines)
        if bit:
            T, lines = _add_step(T, (xq, yq), xp, yp)
            f = times_lines(f, lines)
    f = ft.fq12_conj(f)
    return f, ft.fq12_is_one(final_exponentiation(f))


def pairing_check(xps, yps, xqs, yqs, skip=None):
    """Batched check  prod_i e(P_i, Q_i) == 1  over the trailing pairs axis.

    xps, yps: G1 affine [..., k, 32]; xqs, yqs: twist G2 affine
    [..., k, 2, 32], Montgomery limbs; skip: bool [..., k] (pairs that
    contribute one).  Returns the verdicts, bool [...]: one launch of the
    four-warps-a-job check on the card, its plain version on the CPU."""
    from . import bls381_cuda
    k = xps.shape[-2]
    b = xps[..., 0, 0].numel()
    if skip is None:
        skip = torch.zeros(xps.shape[:-1], dtype=torch.bool,
                           device=xps.device)
    _, ok = bls381_cuda.pairing_check(
        xps.reshape(b, k, fq.LIMBS), yps.reshape(b, k, fq.LIMBS),
        xqs.reshape(b, k, 2, fq.LIMBS), yqs.reshape(b, k, 2, fq.LIMBS),
        skip.reshape(b, k).to(torch.bool))
    return ok.reshape(xps.shape[:-2])


# ---------------------------------------------------------------------------
# the folded flush (sigpipe/fold.py, parallel/shard_verify.pairing_fold)
# ---------------------------------------------------------------------------
# One flush of N signature sets folds its N signature legs e(-c_i g1, sig_i)
# into one pair e(-g1, S), S = sum_i c_i sig_i, and decides the flush with
# the product of N + 1 Miller loops.  The reference fuses the cofactor
# ladder, the weighting, the G2 sum, the affine conversion and the partial
# Miller product into one XLA program; here the pairs come from
# bls381_cuda.fold_lanes (csrc/bls381_fold.cu's legs, the cofactor kernel
# and a segment sum) and go through the pairing kernel's two launches.

_FOLD_CONSTS: dict = {}     # device -> the packed constants, once a device


def _fold_consts(device="cpu"):
    """The affine constants the fold substitutes and appends, as limbs on
    `device`: (g1 gen x, y [32], g2 gen x, y [2, 32], -g1 x, y [32])."""
    key = str(torch.device(device))
    if key not in _FOLD_CONSTS:
        from ..crypto import curve as cv
        g1x, g1y = cv.g1_generator().affine()
        g2x, g2y = cv.g2_generator().affine()
        n1x, n1y = (-cv.g1_generator()).affine()
        _FOLD_CONSTS[key] = (
            fq.pack_mont([g1x.v], device)[0], fq.pack_mont([g1y.v], device)[0],
            ft.fq2_pack_mont([g2x], device)[0],
            ft.fq2_pack_mont([g2y], device)[0],
            fq.pack_mont([n1x.v], device)[0], fq.pack_mont([n1y.v], device)[0])
    return _FOLD_CONSTS[key]


_H_EFF: dict = {}           # device -> the cofactor ladder's bits


def _h_eff_bits(device="cpu"):
    """The bits of h_eff on `device`, once a device: exactly the bits
    ops/bls_cuda.py `hash_to_g2_batch` walks."""
    key = str(torch.device(device))
    if key not in _H_EFF:
        from .bls_cuda import _H_EFF_BITS
        _H_EFF[key] = torch.from_numpy(_H_EFF_BITS).to(device)
    return _H_EFF[key]


def _g1_jacobian_to_affine(P, sub_x, sub_y):
    """Batched Jacobian -> affine over G1 limbs: (x, y, inf).  Infinity rows
    (Z == 0) read the substitute coordinates and set the mask."""
    X, Y, Z = P
    inf = fq.is_zero(Z)
    zi = ft.fq_inv(fq.select(inf, fq.one_mont(Z), Z))
    zi2 = fq.square(zi)
    x = fq.mul(X, zi2)
    y = fq.mul(Y, fq.mul(zi2, zi))
    return (fq.select(inf, sub_x.expand_as(x), x),
            fq.select(inf, sub_y.expand_as(y), y), inf)


def _g2_jacobian_to_affine(P, sub_x, sub_y):
    """Batched Jacobian -> affine over G2 (Fq2) limbs: (x, y, inf)."""
    X, Y, Z = P
    inf = ft.fq2_is_zero(Z)
    pick = inf[..., None, None]
    zi = ft.fq2_inv(torch.where(pick, ft.fq2_one(Z), Z))
    zi2 = ft.fq2_square(zi)
    x = ft.fq2_mul(X, zi2)
    y = ft.fq2_mul(Y, ft.fq2_mul(zi2, zi))
    return (torch.where(pick, sub_x.expand_as(x), x),
            torch.where(pick, sub_y.expand_as(y), y), inf)


def _fold_assemble(w, H, S, consts):
    """The flush's k + 1 Miller pairs from the weighted aggregates w and
    hashes H (Jacobian, [k, ...]) and the signature sum S (Jacobian): k
    legs (w_i, H_i) and the last (-g1, S), affine, with the skip mask
    (w_i or H_i at infinity; S at infinity)."""
    g1x, g1y, g2x, g2y, n1x, n1y = consts
    xw, yw, w_inf = _g1_jacobian_to_affine(w, g1x, g1y)
    xh, yh, h_inf = _g2_jacobian_to_affine(H, g2x, g2y)
    xs, ys, s_inf = _g2_jacobian_to_affine(
        tuple(c[None] for c in S), g2x, g2y)
    return (torch.cat([xw, n1x[None]]), torch.cat([yw, n1y[None]]),
            torch.cat([xh, xs]), torch.cat([yh, ys]),
            torch.cat([w_inf | h_inf, s_inf]))


def _fold_lanes_plain(aggP, cbits, hP, sP, hbits, consts):
    """Plain version of bls381_cuda.fold_lanes (the reference's
    `_fold_partial_core` up to its Miller loops): the weighting ladder
    w_i = c_i agg_i, the cofactor ladder H_i = h_eff Q_i, the signature sum
    S = sum_i c_i sig_i by halving, and the assembled pairs."""
    from . import bls381_cuda, curve_torch
    F1, F2 = curve_torch.F1, curve_torch.F2
    k = aggP[0].shape[0]
    w = curve_torch.point_scalar_mul(F1, aggP, cbits)
    H = curve_torch.point_scalar_mul(F2, hP, hbits.expand(k, -1))
    sw = curve_torch.point_scalar_mul(F2, sP, cbits)
    S = tuple(c[0] for c in bls381_cuda.halving_sum(
        F2, tuple(c[None] for c in sw)))
    return _fold_assemble(w, H, S, consts)


def fold_partial_products(aggP, cbits, hP, sP):
    """The partial Fq12 product of one folded flush, width 1: its k
    weighted-aggregate Miller legs times its e(-g1, S) leg, [12, 32], no
    final exponentiation.  aggP (X, Y, Z) [k, 32] Jacobian aggregates;
    cbits [k, 64] msb-first coefficient bits; hP, sP (X, Y, Z) [k, 2, 32]
    Jacobian pre-cofactor hash points and signatures; k a power of two.
    On the card the fold's launches (`bls381_cuda.fold_lanes`: its own
    FOLD_LAUNCHES, the cofactor kernel and a segment sum), the Miller loops
    and the product launch without the final exponentiation; the plain
    versions on CPU tensors."""
    from . import bls381_cuda
    device = aggP[0].device
    xp, yp, xq, yq, skip = bls381_cuda.fold_lanes(
        aggP, cbits, hP, sP, _fold_consts(device))
    f = bls381_cuda.miller(xp, yp, xq, yq, skip)
    prod, _ = bls381_cuda.product_final(f[None], final=False)
    return prod[0]
