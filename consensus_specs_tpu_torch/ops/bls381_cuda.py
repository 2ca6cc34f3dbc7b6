"""The CUDA BLS12-381 kernels: layouts, launch and count.

Counterparts of the XLA device programs of consensus_specs_tpu/ops/fq.py,
fq_tower.py, curve_jax.py, pairing_jax.py, g1_sweep.py and msm.py.  Eight
kernels, written for sm_90a on one set of device functions
(csrc/bls381.cuh, and for the cofactor and check kernels its
register-resident redesign csrc/bls381_reg.cuh), built at first use with
the port's other kernels (ops/cuda_build.py):

- csrc/bls381_pairing.cu, the pairing check in two launches: `miller`
  (launch 1, a Miller loop a pair) and `product_final` (launch 2, a job's
  product and final exponentiation);
- csrc/bls381_g2.cu, the G2 ladder: `g2_ladder`;
- csrc/bls381_field.cu, one elementwise kernel over the field, tower and
  curve ops: `field_op`;
- csrc/bls381_msm.cu, the segment sums of G1 or G2 points (`segment_sum`,
  K1) and the G1 ladder (`g1_ladder`, K2);
- csrc/bls381_fold.cu, the lanes and the last pair of a folded signature
  flush (`fold_lanes`, K4, with a K1 launch between its two launches);
- csrc/bls381_cofactor.cu, G2 cofactor clearing by the psi endomorphism
  with the affine result (`clear_cofactor_g2`, a thread a point);
- csrc/bls381_check.cu, the pairing check in one launch, four warps a job
  (`pairing_check`).  These two replace the ladder, the field kernel and
  the pairing kernel's two launches on the check-by-check path; the older
  kernels stay for the signature flush and the staged multi-exponentiation;
- csrc/bls381_pippenger.cu, the windowed Pippenger G1 MSM of the KZG
  engine in three launches (`pippenger_g1`; device bodies
  csrc/bls381_pippenger.cuh on bls381.cuh).

Each wrapper takes and returns the plain version's limb layout (int64
[..., 32] 12-bit limbs, ops/fq.py) and repacks to the kernels' 12 x 32-bit
words on the card (`fq.to_words` / `fq.from_words`).  On CUDA tensors it
launches its kernel or raises; on CPU tensors it runs the plain version, and
only for that reason.  `.launches` counts kernel launches and `.plain_calls`
calls that took the plain version.
"""
from __future__ import annotations

import math

import torch

from . import cuda_build, curve_torch, fq, pairing_torch
from . import fq_tower as ft

F1, F2 = curve_torch.F1, curve_torch.F2


def _g1(fn):
    return lambda a, *b: torch.stack(
        fn(F1, a.unbind(-2), *(p.unbind(-2) for p in b)), dim=-2)


def _g2(fn):
    return lambda a, *b: torch.stack(
        fn(F2, a.unbind(-3), *(p.unbind(-3) for p in b)), dim=-3)


# op name: (element limb shape, arity, plain version), in the order of
# csrc/bls381.cuh `enum FieldOp` (the op code is the index)
FIELD_OPS = {
    "fq_mul": ((32,), 2, fq.mul),
    "fq_add": ((32,), 2, fq.add),
    "fq_sub": ((32,), 2, fq.sub),
    "fq_neg": ((32,), 1, fq.neg),
    "fq_inv": ((32,), 1, ft.fq_inv),
    "fq2_mul": ((2, 32), 2, ft.fq2_mul),
    "fq2_square": ((2, 32), 1, ft.fq2_square),
    "fq2_inv": ((2, 32), 1, ft.fq2_inv),
    "fq12_mul": ((12, 32), 2, ft.fq12_mul),
    "fq12_square": ((12, 32), 1, ft.fq12_square),
    "fq12_cyclotomic_square": ((12, 32), 1, ft.fq12_cyclotomic_square),
    "fq12_frobenius1": ((12, 32), 1, lambda a: ft.fq12_frobenius(a, 1)),
    "fq12_frobenius2": ((12, 32), 1, lambda a: ft.fq12_frobenius(a, 2)),
    "fq12_frobenius3": ((12, 32), 1, lambda a: ft.fq12_frobenius(a, 3)),
    "fq12_conj": ((12, 32), 1, ft.fq12_conj),
    "fq12_inv": ((12, 32), 1, ft.fq12_inv),
    "g1_add": ((3, 32), 2, _g1(curve_torch.point_add)),
    "g1_double": ((3, 32), 1, _g1(curve_torch.point_double)),
    "g2_add": ((3, 2, 32), 2, _g2(curve_torch.point_add)),
    "g2_double": ((3, 2, 32), 1, _g2(curve_torch.point_double)),
}
_OP_CODE = {name: i for i, name in enumerate(FIELD_OPS)}


def _check(name, t, suffix, dtype, device=None):
    if t.dim() < len(suffix) or tuple(t.shape[-len(suffix):]) != suffix:
        raise ValueError(f"{name}: expected shape [..., "
                         f"{', '.join(map(str, suffix))}], got "
                         f"{tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} on unsupported device {t.device}")


def _words(limbs):
    return fq.to_words(limbs).contiguous()


def field_op(op: str, a: torch.Tensor, b: torch.Tensor | None = None):
    """out = op(a[, b]) elementwise over int64 limb tensors whose trailing
    shape is the op's element shape (FIELD_OPS); a binary op's inputs must
    have one shape.  The kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if op not in FIELD_OPS:
        raise ValueError(f"unknown field op {op!r}")
    suffix, arity, plain = FIELD_OPS[op]
    _check(f"{op} a", a, suffix, torch.int64)
    if (b is None) != (arity == 1):
        raise ValueError(f"{op} takes {arity} operand(s)")
    if b is not None:
        _check(f"{op} b", b, suffix, torch.int64, a.device)
        if b.shape != a.shape:
            raise ValueError(f"{op}: shapes {tuple(a.shape)} and "
                             f"{tuple(b.shape)} differ")
    if a.device.type == "cpu":
        field_op.plain_calls += 1
        return plain(a) if b is None else plain(a, b)
    kernels = cuda_build.build()
    n = a.numel() // math.prod(suffix)
    wa = _words(a)
    wb = None if b is None else _words(b)
    out = torch.empty_like(wa)
    if n:
        kernels.field(_OP_CODE[op], wa, wb, out, n)
        field_op.launches += 1
    return fq.from_words(out)


field_op.launches = 0
field_op.plain_calls = 0


def g2_ladder(pt, bits):
    """The G2 ladder: msb-first double-and-add of each Jacobian point
    (X, Y, Z), each [n, 2, 32] int64 limbs, over its bit row of `bits`
    [n, nbits] (0/1, any integer or bool dtype).  Returns (X, Y, Z) in the
    same layout.  The kernel on CUDA tensors, the plain version
    (curve_torch.point_scalar_mul) on CPU tensors."""
    X, Y, Z = pt
    for name, t in zip("XYZ", pt):
        _check(f"g2_ladder {name}", t, (2, 32), torch.int64, X.device)
        if t.shape != X.shape or t.dim() != 3:
            raise ValueError(f"g2_ladder: expected [n, 2, 32] coordinates, "
                             f"got {tuple(t.shape)}")
    n = X.shape[0]
    if bits.dim() != 2 or bits.shape[0] != n:
        raise ValueError(f"g2_ladder: expected bits [{n}, nbits], got "
                         f"{tuple(bits.shape)}")
    if bits.device != X.device:
        raise ValueError(f"g2_ladder: bits on {bits.device}, points on "
                         f"{X.device}")
    if X.device.type == "cpu":
        g2_ladder.plain_calls += 1
        return curve_torch.point_scalar_mul(F2, pt, bits)
    kernels = cuda_build.build()
    words = _words(torch.stack(pt, dim=1))            # [n, 3, 2, 12]
    bits8 = bits.to(torch.uint8).contiguous()
    out = torch.empty_like(words)
    if n:
        kernels.ladder(words, bits8, bits.shape[1], out, n)
        g2_ladder.launches += 1
    return tuple(fq.from_words(out).unbind(1))


g2_ladder.launches = 0
g2_ladder.plain_calls = 0


def g1_ladder(pt, bits):
    """K2, the G1 ladder: msb-first double-and-add of each Jacobian point
    (X, Y, Z), each [n, 32] int64 limbs, over its bit row of `bits`
    [n, nbits] (0/1).  Returns (X, Y, Z) in the same layout.  The kernel on
    CUDA tensors, the plain version (curve_torch.point_scalar_mul) on CPU
    tensors."""
    X, Y, Z = pt
    for name, t in zip("XYZ", pt):
        _check(f"g1_ladder {name}", t, (32,), torch.int64, X.device)
        if t.shape != X.shape or t.dim() != 2:
            raise ValueError(f"g1_ladder: expected [n, 32] coordinates, "
                             f"got {tuple(t.shape)}")
    n = X.shape[0]
    if bits.dim() != 2 or bits.shape[0] != n or bits.device != X.device:
        raise ValueError(f"g1_ladder: expected bits [{n}, nbits] on "
                         f"{X.device}, got {tuple(bits.shape)} on "
                         f"{bits.device}")
    if X.device.type == "cpu":
        g1_ladder.plain_calls += 1
        return curve_torch.point_scalar_mul(F1, pt, bits)
    kernels = cuda_build.build()
    words = _words(torch.stack(pt, dim=1))            # [n, 3, 12]
    bits8 = bits.to(torch.uint8).contiguous()
    out = torch.empty_like(words)
    if n:
        kernels.g1_ladder(words, bits8, bits.shape[1], out, n)
        g1_ladder.launches += 1
    return tuple(fq.from_words(out).unbind(1))


g1_ladder.launches = 0
g1_ladder.plain_calls = 0


def halving_sum(F, pt):
    """Plain version of K1: (X, Y, Z) [s, L, ...] -> [s, ...], L a power of
    two, by log2(L) halving rounds that add point i + h into point i (the
    pair order of the reference's `_jax_sweep` and `_tree_sum_host`)."""
    X, Y, Z = pt
    while X.shape[1] > 1:
        h = X.shape[1] // 2
        X, Y, Z = curve_torch.point_add(F, (X[:, :h], Y[:, :h], Z[:, :h]),
                                        (X[:, h:], Y[:, h:], Z[:, h:]))
    return X[:, 0], Y[:, 0], Z[:, 0]


def _segment_sum_words(g2, buf, length, out, segments):
    """Launch K1 on word tensors: buf [segments, length, point] summed in
    place, each segment's sum written to out [segments, point]."""
    if segments:
        cuda_build.build().segment_sum(g2, buf, length, out, segments)
        segment_sum.launches += 1


def segment_sum(pt):
    """K1, the segment sums: (X, Y, Z), each [s, L, 32] (G1) or
    [s, L, 2, 32] (G2) int64 limbs with L a power of two, -> the sum of
    each segment, (X, Y, Z) [s, 32] or [s, 2, 32], Jacobian, equal to the
    plain version's coordinates bit for bit (the same pair order).  The
    kernel on CUDA tensors (one thread block a segment, halving in place in
    a scratch copy), the plain version (`halving_sum`) on CPU tensors."""
    X = pt[0]
    g2 = X.dim() == 4
    suffix = (2, 32) if g2 else (32,)
    for name, t in zip("XYZ", pt):
        _check(f"segment_sum {name}", t, suffix, torch.int64, X.device)
        if t.shape != X.shape or t.dim() != 2 + len(suffix):
            raise ValueError(f"segment_sum: expected [s, L, "
                             f"{', '.join(map(str, suffix))}] coordinates, "
                             f"got {tuple(t.shape)}")
    s, length = X.shape[:2]
    if length < 1 or length & (length - 1):
        raise ValueError(f"segment_sum: segment length {length} is not a "
                         f"power of two")
    if X.device.type == "cpu":
        segment_sum.plain_calls += 1
        return halving_sum(F2 if g2 else F1, pt)
    buf = _words(torch.stack(pt, dim=2))     # the scratch copy, summed in place
    out = torch.empty((s,) + tuple(buf.shape[2:]), dtype=buf.dtype,
                      device=buf.device)
    _segment_sum_words(g2, buf, length, out, s)
    return tuple(fq.from_words(out).unbind(1))


segment_sum.launches = 0
segment_sum.plain_calls = 0


def fold_lanes(aggP, cbits, hP, sP, hbits, consts):
    """K4: the Miller inputs of a folded flush's k + 1 pairs.  aggP (X, Y,
    Z) [k, 32] G1 aggregates; cbits [k, nc] msb-first 0/1 coefficient
    bits; hP and sP (X, Y, Z) [k, 2, 32], the pre-cofactor hash points and
    the signatures; hbits [nh] the cofactor ladder's bits; consts the limbs
    of (g1x, g1y, g2x, g2y, n1x, n1y) (pairing_torch._fold_consts); k a
    power of two.  Returns (xp [k + 1, 32], yp, xq [k + 1, 2, 32], yq, skip
    bool [k + 1]): pair i < k is (c_i agg_i, h_eff Q_i), the last
    (-G1, sum_i c_i sig_i), affine, skipped where a side is infinity.

    On CUDA tensors: launch 1 (a thread a lane: its three ladders and two
    affine conversions), K1 over the lanes' c_i sig_i (counted in
    `segment_sum.launches`), launch 3 (the last pair); two launches of
    this wrapper's count a flush.  On CPU tensors the plain version
    (pairing_torch._fold_lanes_plain)."""
    X = aggP[0]
    k = X.shape[0]
    for name, t in zip("XYZ", aggP):
        _check(f"fold_lanes agg {name}", t, (32,), torch.int64, X.device)
        if t.shape != (k, 32):
            raise ValueError(f"fold_lanes: expected agg [{k}, 32], got "
                             f"{tuple(t.shape)}")
    for label, p in (("h", hP), ("sig", sP)):
        for name, t in zip("XYZ", p):
            _check(f"fold_lanes {label} {name}", t, (2, 32), torch.int64,
                   X.device)
            if t.shape != (k, 2, 32):
                raise ValueError(f"fold_lanes: expected {label} [{k}, 2, "
                                 f"32], got {tuple(t.shape)}")
    if cbits.dim() != 2 or cbits.shape[0] != k or hbits.dim() != 1 \
            or cbits.device != X.device or hbits.device != X.device:
        raise ValueError(f"fold_lanes: expected cbits [{k}, nc] and hbits "
                         f"[nh] on {X.device}")
    if k < 1 or k & (k - 1):
        raise ValueError(f"fold_lanes: {k} lanes is not a power of two")
    if X.device.type == "cpu":
        fold_lanes.plain_calls += 1
        return pairing_torch._fold_lanes_plain(aggP, cbits, hP, sP, hbits,
                                               consts)
    kernels = cuda_build.build()
    dev = X.device
    agg = _words(torch.stack(aggP, dim=1))            # [k, 3, 12]
    hq = _words(torch.stack(hP, dim=1))               # [k, 3, 2, 12]
    sig = _words(torch.stack(sP, dim=1))
    cb = cbits.to(torch.uint8).contiguous()
    hb = hbits.to(torch.uint8).contiguous()
    cw = torch.cat([fq.to_words(c).reshape(-1) for c in consts]).contiguous()
    g1 = torch.empty((k + 1, 2, fq.WORDS), dtype=torch.int32, device=dev)
    g2 = torch.empty((k + 1, 2, 2, fq.WORDS), dtype=torch.int32, device=dev)
    skip = torch.empty(k + 1, dtype=torch.uint8, device=dev)
    sw = torch.empty((1, k, 3, 2, fq.WORDS), dtype=torch.int32, device=dev)
    S = torch.empty((1, 3, 2, fq.WORDS), dtype=torch.int32, device=dev)
    kernels.fold_lanes(agg, cb, cb.shape[1], hq, sig, hb, hb.shape[0], cw,
                       g1, g2, skip, sw, k)
    fold_lanes.launches += 1
    _segment_sum_words(True, sw, k, S, 1)
    kernels.fold_tail(S, cw, g1, g2, skip, k)
    fold_lanes.launches += 1
    p, q = fq.from_words(g1), fq.from_words(g2)
    return p[:, 0], p[:, 1], q[:, 0], q[:, 1], skip.to(torch.bool)


fold_lanes.launches = 0
fold_lanes.plain_calls = 0


def miller(xp, yp, xq, yq, skip):
    """Launch 1 of the pairing check: the Miller loop of each pair, P =
    (xp, yp) [n, 32], Q = (xq, yq) [n, 2, 32] affine Montgomery limbs,
    skip bool [n].  Returns f [n, 12, 32] (conjugated; one where skip).
    The kernel on CUDA tensors, the plain version
    (pairing_torch.miller_loop) on CPU tensors."""
    n = xp.shape[0] if xp.dim() == 2 else -1
    for name, t, suffix in (("xp", xp, (32,)), ("yp", yp, (32,)),
                            ("xq", xq, (2, 32)), ("yq", yq, (2, 32))):
        _check(f"miller {name}", t, suffix, torch.int64, xp.device)
        if t.dim() != 1 + len(suffix) or t.shape[0] != n:
            raise ValueError(f"miller {name}: expected [{n}, "
                             f"{', '.join(map(str, suffix))}], got "
                             f"{tuple(t.shape)}")
    if skip.shape != (n,) or skip.dtype != torch.bool \
            or skip.device != xp.device:
        raise ValueError(f"miller: expected a bool skip mask [{n}] on "
                         f"{xp.device}")
    if xp.device.type == "cpu":
        miller.plain_calls += 1
        return pairing_torch.miller_loop(xp, yp, xq, yq, skip)
    kernels = cuda_build.build()
    g1 = _words(torch.stack([xp, yp], dim=1))        # [n, 2, 12]
    g2 = _words(torch.stack([xq, yq], dim=1))        # [n, 2, 2, 12]
    f = torch.empty((n, 12, fq.WORDS), dtype=torch.int32, device=xp.device)
    if n:
        kernels.miller(g1, g2, skip.to(torch.uint8).contiguous(), f, n)
        miller.launches += 1
    return fq.from_words(f)


miller.launches = 0
miller.plain_calls = 0


def product_final(f, final: bool = True):
    """Launch 2 of the pairing check: f [b, k, 12, 32] Miller values ->
    (product [b, 12, 32], is_one bool [b] of the product's final
    exponentiation, or None without `final`).  The kernel on CUDA tensors,
    the plain version (pairing_torch.product_final) on CPU tensors."""
    _check("product_final f", f, (12, 32), torch.int64)
    if f.dim() != 4 or f.shape[1] < 1:
        raise ValueError(f"product_final: expected f [b, k >= 1, 12, 32], "
                         f"got {tuple(f.shape)}")
    if f.device.type == "cpu":
        product_final.plain_calls += 1
        return pairing_torch.product_final(f, final)
    kernels = cuda_build.build()
    b, k = f.shape[:2]
    words = _words(f)
    prod = torch.empty((b, 12, fq.WORDS), dtype=torch.int32, device=f.device)
    ok = torch.zeros(b, dtype=torch.uint8, device=f.device)
    if b:
        kernels.final(words, k, bool(final), prod, ok, b)
        product_final.launches += 1
    return fq.from_words(prod), (ok.to(torch.bool) if final else None)


product_final.launches = 0
product_final.plain_calls = 0

def clear_cofactor_g2(pt):
    """h_eff P of each Jacobian G2 point (X, Y, Z), each [n, 2, 32] int64
    limbs, made affine: returns (x, y) [n, 2, 32] (zeros at infinity) and
    inf bool [n].  The kernel on CUDA tensors (csrc/bls381_cofactor.cu, psi
    and the affine words in one launch), the plain version
    (curve_torch.clear_cofactor_g2_plain) on CPU tensors."""
    X = pt[0]
    for name, t in zip("XYZ", pt):
        _check(f"clear_cofactor_g2 {name}", t, (2, 32), torch.int64, X.device)
        if t.shape != X.shape or t.dim() != 3:
            raise ValueError(f"clear_cofactor_g2: expected [n, 2, 32] "
                             f"coordinates, got {tuple(t.shape)}")
    if X.device.type == "cpu":
        clear_cofactor_g2.plain_calls += 1
        return curve_torch.clear_cofactor_g2_plain(pt)
    kernels = cuda_build.build()
    n = X.shape[0]
    words = _words(torch.stack(pt, dim=1))            # [n, 3, 2, 12]
    consts = _words(curve_torch.psi_consts(X.device))   # [2, 2, 12]
    xy = torch.empty((n, 2, 2, fq.WORDS), dtype=torch.int32, device=X.device)
    inf = torch.empty(n, dtype=torch.uint8, device=X.device)
    if n:
        kernels.clear_cofactor(words, consts, xy, inf, n)
        clear_cofactor_g2.launches += 1
    out = fq.from_words(xy)
    return out[:, 0], out[:, 1], inf.to(torch.bool)


clear_cofactor_g2.launches = 0
clear_cofactor_g2.plain_calls = 0


def pairing_check(xp, yp, xq, yq, skip):
    """The pairing check of b jobs of k pairs: P = (xp, yp) [b, k, 32],
    Q = (xq, yq) [b, k, 2, 32] affine Montgomery limbs, skip bool [b, k]
    (pairs that contribute one).  Returns (product [b, 12, 32] of each
    job's Miller values before the final exponentiation, ok bool [b]).  The
    kernel on CUDA tensors (csrc/bls381_check.cu, one launch, four warps a
    job), the plain version (pairing_torch.check_plain) on CPU tensors."""
    if xp.dim() != 3:
        raise ValueError(f"pairing_check: expected xp [b, k, 32], got "
                         f"{tuple(xp.shape)}")
    b, k = xp.shape[:2]
    for name, t, suffix in (("xp", xp, (32,)), ("yp", yp, (32,)),
                            ("xq", xq, (2, 32)), ("yq", yq, (2, 32))):
        _check(f"pairing_check {name}", t, suffix, torch.int64, xp.device)
        if tuple(t.shape) != (b, k) + suffix:
            raise ValueError(f"pairing_check {name}: expected "
                             f"{(b, k) + suffix}, got {tuple(t.shape)}")
    if skip.shape != (b, k) or skip.dtype != torch.bool \
            or skip.device != xp.device:
        raise ValueError(f"pairing_check: expected a bool skip mask "
                         f"[{b}, {k}] on {xp.device}")
    if k < 1:
        raise ValueError("pairing_check: a job needs k >= 1 pairs")
    if xp.device.type == "cpu":
        pairing_check.plain_calls += 1
        return pairing_torch.check_plain(xp, yp, xq, yq, skip)
    kernels = cuda_build.build()
    dev = xp.device
    g1 = _words(torch.stack([xp, yp], dim=2))          # [b, k, 2, 12]
    g2 = _words(torch.stack([xq, yq], dim=2))          # [b, k, 2, 2, 12]
    tq = torch.empty((b, k, 6 * fq.WORDS), dtype=torch.int32, device=dev)
    prod = torch.empty((b, 12, fq.WORDS), dtype=torch.int32, device=dev)
    ok = torch.zeros(b, dtype=torch.uint8, device=dev)
    if b:
        kernels.pairing_check(g1, g2, skip.to(torch.uint8).contiguous(), tq,
                              prod, ok, k, b)
        pairing_check.launches += 1
    return fq.from_words(prod), ok.to(torch.bool)


pairing_check.launches = 0
pairing_check.plain_calls = 0


def pippenger_g1(pt, digits):
    """sum_i s_i P_i over G1 by the windowed Pippenger method at the
    reference's parameters (8-bit windows, 16 bucket-table lanes): pt =
    (X, Y, Z), each [n, 32] int64 Jacobian Montgomery limbs, n a multiple
    of 16; digits [32, n] (any integer dtype, values below 256), window 0
    most significant (ops/msm.py `_digits_np`).  Returns one Jacobian point
    (X, Y, Z), each [32], equal to the plain version's bit for bit.

    On CUDA tensors the three launches of csrc/bls381_pippenger.cu (the
    fold, the windows' merge and scans, Horner), each counted; the bucket
    tables (18.9 MB at any n) and scan buffers are scratch allocated here.
    On CPU tensors the plain version (ops/msm.py `_pippenger_g1`)."""
    X = pt[0]
    for name, t in zip("XYZ", pt):
        _check(f"pippenger_g1 {name}", t, (32,), torch.int64, X.device)
        if t.shape != X.shape or t.dim() != 2:
            raise ValueError(f"pippenger_g1: expected [n, 32] coordinates, "
                             f"got {tuple(t.shape)}")
    n = X.shape[0]
    if n % PIPPENGER_LANES:
        raise ValueError(f"pippenger_g1: {n} points is not a multiple of "
                         f"{PIPPENGER_LANES}")
    if digits.shape != (PIPPENGER_WINDOWS, n) or digits.device != X.device:
        raise ValueError(f"pippenger_g1: expected digits "
                         f"[{PIPPENGER_WINDOWS}, {n}] on {X.device}, got "
                         f"{tuple(digits.shape)} on {digits.device}")
    if X.device.type == "cpu":
        pippenger_g1.plain_calls += 1
        from . import msm
        return msm._pippenger_g1(*pt, digits)
    kernels = cuda_build.build()
    dev = X.device
    words = _words(torch.stack(pt, dim=1))            # [n, 3, 12]
    d8 = digits.to(torch.uint8).contiguous()
    tables = torch.empty((PIPPENGER_WINDOWS, PIPPENGER_LANES, 256, 3,
                          fq.WORDS), dtype=torch.int32, device=dev)
    scan = torch.empty((PIPPENGER_WINDOWS, 2, 255, 3, fq.WORDS),
                       dtype=torch.int32, device=dev)
    G = torch.empty((PIPPENGER_WINDOWS, 3, fq.WORDS), dtype=torch.int32,
                    device=dev)
    out = torch.empty((3, fq.WORDS), dtype=torch.int32, device=dev)
    kernels.pippenger_fold(words, d8, n, tables)
    pippenger_g1.launches += 1
    kernels.pippenger_window(tables, scan, G)
    pippenger_g1.launches += 1
    kernels.pippenger_horner(G, out)
    pippenger_g1.launches += 1
    return tuple(fq.from_words(out).unbind(0))


PIPPENGER_WINDOWS, PIPPENGER_LANES = 32, 16
PIPPENGER_LAUNCHES = 3          # launches of one pippenger_g1 call
pippenger_g1.launches = 0
pippenger_g1.plain_calls = 0

# every wrapper of the BLS kernels, by kernel name (chip_smoke.py reads
# and resets their counts); K1 and K2 share csrc/bls381_msm.cu
WRAPPERS = {"bls381_pairing": (miller, product_final),
            "bls381_g2": (g2_ladder,), "bls381_field": (field_op,),
            "bls381_segment_sum": (segment_sum,),
            "bls381_g1_ladder": (g1_ladder,), "bls381_fold": (fold_lanes,),
            "bls381_cofactor": (clear_cofactor_g2,),
            "bls381_check": (pairing_check,),
            "bls381_pippenger": (pippenger_g1,)}
