"""The CUDA BLS12-381 kernels: layouts, launch and count.

Counterparts of the XLA device programs of consensus_specs_tpu/ops/fq.py,
fq_tower.py, curve_jax.py, pairing_jax.py, g1_sweep.py and msm.py.  Eight
kernels, written for sm_90a on one set of device functions
(csrc/bls381.cuh, and for the cofactor, check and pairing kernels its
register-resident redesign csrc/bls381_reg.cuh), built at first use with
the port's other kernels (ops/cuda_build.py):

- the pairing in two launches, four warps a pair or a job on the check's
  levels (bodies csrc/bls381_pairing.cuh on csrc/bls381_check.cuh, kernels
  in csrc/bls381_check.cu): `miller` (launch 1, a pair's Miller loop a
  block) and `product_final` (launch 2, a job's product and final
  exponentiation a block);
- csrc/bls381_g2.cu, the G2 ladder: `g2_ladder`, on the windowed body
  of csrc/bls381_ladder.cuh;
- csrc/bls381_field.cu, one elementwise kernel over the field, tower and
  curve ops: `field_op`;
- csrc/bls381_msm.cu, the G1 ladder (`g1_ladder`, K2, the same windowed
  body with the GLV split);
- csrc/bls381_fold.cu, the lanes and the last pair of a folded signature
  flush (`fold_lanes`, K4: a set's three legs as kernels of their own on
  three streams, its cofactor by bls381_cofactor.cu's kernel; a K1 launch
  sums the signature leg; bodies csrc/bls381_fold.cuh);
- csrc/bls381_cofactor.cu, G2 cofactor clearing by the psi endomorphism
  with the affine result (`clear_cofactor_g2`, a thread a point);
- csrc/bls381_check.cu, the pairing check in one launch, four warps a job
  (`pairing_check`), and on the same levels the segment sums of G1 or G2
  points (`segment_sum`, K1, a block a segment; bodies
  csrc/bls381_segment.cuh).  These two replace the ladder, the field kernel and
  the pairing kernel's two launches on the check-by-check path; the
  pairing's launches stay for the signature flush, the ladder for the
  staged multi-exponentiation;
- csrc/bls381_pippenger.cu, the windowed Pippenger G1 MSM of the KZG
  engine in five launches (`pippenger_g1`; device bodies
  csrc/bls381_pippenger.cuh on bls381.cuh), held to the plain version's
  affine result.

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
    """The G2 ladder: s P of each Jacobian point (X, Y, Z), each [n, 2, 32]
    int64 limbs, over its msb-first bit row of `bits` [n, nbits] (0/1, any
    integer or bool dtype), by regular signed windows over a table of odd
    multiples (csrc/bls381_ladder.cuh).  Returns (X, Y, Z) in the same
    layout.  Any point of E'(Fq2): no subgroup is assumed.  The kernel on
    CUDA tensors, the plain version (curve_torch.windowed_ladder) on CPU
    tensors."""
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
        return curve_torch.windowed_ladder(F2, pt, bits)
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
    """K2, the G1 ladder: s P of each Jacobian point (X, Y, Z), each
    [n, 32] int64 limbs, by regular signed windows over a table of odd
    multiples (csrc/bls381_ladder.cuh).  `bits` is either [n, nbits], each
    row s's msb-first bits (0/1), or [n, 2, GLV_BITS], each row split by
    GLV (curve_torch.glv_bits: s0's bits, then s1's, s = s0 + s1 lambda
    mod r), which halves the chain of a row wider than 128 bits.  Returns
    (X, Y, Z) in the same layout.

    Precondition of split rows: every point lies in the r-torsion subgroup
    (phi(P) = [lambda] P holds only there), as the points of ops/msm.py's
    callers do (decoded with a subgroup check, or the KZG ceremony's
    setup); a caller that cannot promise it passes unsplit rows, which
    hold for any point.  The kernel on CUDA tensors, the plain version
    (curve_torch.windowed_ladder, curve_torch.glv_ladder) on CPU
    tensors."""
    X, Y, Z = pt
    for name, t in zip("XYZ", pt):
        _check(f"g1_ladder {name}", t, (32,), torch.int64, X.device)
        if t.shape != X.shape or t.dim() != 2:
            raise ValueError(f"g1_ladder: expected [n, 32] coordinates, "
                             f"got {tuple(t.shape)}")
    n = X.shape[0]
    split = bits.dim() == 3
    if not (bits.dim() == 2 or split and tuple(bits.shape[1:]) == (
            2, curve_torch.GLV_BITS)) or bits.shape[0] != n \
            or bits.device != X.device:
        raise ValueError(f"g1_ladder: expected bits [{n}, nbits] or "
                         f"[{n}, 2, {curve_torch.GLV_BITS}] on {X.device}, "
                         f"got {tuple(bits.shape)} on {bits.device}")
    if X.device.type == "cpu":
        g1_ladder.plain_calls += 1
        if split:
            return curve_torch.glv_ladder(pt, bits)
        return curve_torch.windowed_ladder(F1, pt, bits)
    kernels = cuda_build.build()
    words = _words(torch.stack(pt, dim=1))            # [n, 3, 12]
    bits8 = bits.to(torch.uint8).contiguous()
    out = torch.empty_like(words)
    if n:
        kernels.g1_ladder(words, bits8, bits.shape[-1], out, n, split)
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
    kernel on CUDA tensors (one block of four warps a segment, halving in
    place in a scratch copy, a round's adds on five product levels), the
    plain version (`halving_sum`) on CPU tensors."""
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


def fold_lanes(aggP, cbits, hP, sP, consts):
    """K4: the Miller inputs of a folded flush's k + 1 pairs.  aggP (X, Y,
    Z) [k, 32] G1 aggregates; cbits [k, nc] msb-first 0/1 coefficient
    bits; hP and sP (X, Y, Z) [k, 2, 32], the pre-cofactor hash points and
    the signatures; consts the limbs of (g1x, g1y, g2x, g2y, n1x, n1y)
    (pairing_torch._fold_consts); k a power of two.  Returns (xp [k + 1,
    32], yp, xq [k + 1, 2, 32], yq, skip bool [k + 1]): pair i < k is
    (c_i agg_i, h_eff Q_i), the last (-G1, sum_i c_i sig_i), affine,
    skipped where a side is infinity.

    On CUDA tensors, a set's three legs as kernels of their own on three
    streams, forked from the caller's and joined back to it: the cofactor
    leg, h_eff Q by the psi method (csrc/bls381_cofactor.cu, counted in
    `clear_cofactor_g2.launches`) and its generator at infinity; the
    weighting leg, c_i agg_i affine; and on the caller's stream the
    signature leg c_i sig_i, K1 over it (counted in
    `segment_sum.launches`) and the last pair.  FOLD_LAUNCHES of this
    wrapper's count a flush.  On CPU tensors the plain version
    (pairing_torch._fold_lanes_plain, whose cofactor is the ladder over
    h_eff's bits)."""
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
    if cbits.dim() != 2 or cbits.shape[0] != k or cbits.device != X.device:
        raise ValueError(f"fold_lanes: expected cbits [{k}, nc] on "
                         f"{X.device}")
    if k < 1 or k & (k - 1):
        raise ValueError(f"fold_lanes: {k} lanes is not a power of two")
    if X.device.type == "cpu":
        fold_lanes.plain_calls += 1
        return pairing_torch._fold_lanes_plain(
            aggP, cbits, hP, sP, pairing_torch._h_eff_bits(X.device), consts)
    kernels = cuda_build.build()
    dev = X.device
    agg = _words(torch.stack(aggP, dim=1))            # [k, 3, 12]
    hq = _words(torch.stack(hP, dim=1))               # [k, 3, 2, 12]
    sig = _words(torch.stack(sP, dim=1))
    cb = cbits.to(torch.uint8).contiguous()
    nc = cb.shape[1]
    psi = _words(curve_torch.psi_consts(dev))         # [2, 2, 12]
    cw = torch.cat([fq.to_words(c).reshape(-1) for c in consts]).contiguous()
    g1 = torch.empty((k + 1, 2, fq.WORDS), dtype=torch.int32, device=dev)
    g2 = torch.empty((k + 1, 2, 2, fq.WORDS), dtype=torch.int32, device=dev)
    skip = torch.zeros(k + 1, dtype=torch.uint8, device=dev)
    h_inf = torch.empty(k, dtype=torch.uint8, device=dev)
    sw = torch.empty((1, k, 3, 2, fq.WORDS), dtype=torch.int32, device=dev)
    S = torch.empty((1, 3, 2, fq.WORDS), dtype=torch.int32, device=dev)
    main = torch.cuda.current_stream(dev)
    legs = _fold_streams(dev)
    for s in legs:
        s.wait_stream(main)
    with torch.cuda.stream(legs[0]):
        kernels.clear_cofactor(hq, psi, g2[:k], h_inf, k)
        clear_cofactor_g2.launches += 1
        kernels.fold_h(h_inf, cw, g2, skip, k)
        fold_lanes.launches += 1
    with torch.cuda.stream(legs[1]):
        kernels.fold_w(agg, cb, nc, cw, g1, skip, k)
        fold_lanes.launches += 1
    kernels.fold_sw(sig, cb, nc, sw, k)
    fold_lanes.launches += 1
    _segment_sum_words(True, sw, k, S, 1)
    kernels.fold_tail(S, cw, g1, g2, skip, k)
    fold_lanes.launches += 1
    for s in legs:
        main.wait_stream(s)
    p, q = fq.from_words(g1), fq.from_words(g2)
    return p[:, 0], p[:, 1], q[:, 0], q[:, 1], skip.to(torch.bool)


_FOLD_STREAMS = {}


def _fold_streams(device):
    """The two side streams of `fold_lanes` on `device` (the cofactor leg's
    and the weighting leg's), made at the first call there."""
    if device not in _FOLD_STREAMS:
        _FOLD_STREAMS[device] = (torch.cuda.Stream(device),
                                 torch.cuda.Stream(device))
    return _FOLD_STREAMS[device]


FOLD_LAUNCHES = 4               # fold_lanes' own launches a flush
fold_lanes.launches = 0
fold_lanes.plain_calls = 0


def miller(xp, yp, xq, yq, skip):
    """Launch 1 of the pairing: the Miller loop of each pair, P = (xp, yp)
    [n, 32], Q = (xq, yq) [n, 2, 32] affine Montgomery limbs, skip bool
    [n].  Returns f [n, 12, 32] (conjugated; one where skip).  The kernel
    on CUDA tensors (csrc/bls381_pairing.cuh, four warps a pair), the plain
    version (pairing_torch.miller_loop) on CPU tensors."""
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
    """Launch 2 of the pairing: f [b, k, 12, 32] Miller values ->
    (product [b, 12, 32], is_one bool [b] of the product's final
    exponentiation, or None without `final`).  The kernel on CUDA tensors
    (csrc/bls381_pairing.cuh, four warps a job: two running products in
    shared memory, then the final exponentiation), the plain
    version (pairing_torch.product_final) on CPU tensors."""
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


def pippenger_scratch(n, device):
    """The Pippenger kernel's scratch for n points on `device`, by the
    names of its C entry (csrc/bls381_pippenger.cu; layouts
    csrc/bls381_pippenger.cuh): idx, bstart, istart, item_bucket (int32),
    partial, B, tbuf, T, G (points of 3 x 12 words) and out."""
    w, words = PIPPENGER_WINDOWS, fq.WORDS
    m = 255 + -(-n // PIPPENGER_CHUNK)       # item slots a window

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=device)
    return dict(idx=i32(w, n), bstart=i32(w, 257), istart=i32(w, 257),
                item_bucket=i32(w, m), partial=i32(w, m, 3, words),
                B=i32(w, 256, 3, words), tbuf=i32(w, 8, 64, 3, words),
                T=i32(w, 8, 3, words), G=i32(w, 3, words),
                out=i32(3, words))


def pippenger_g1(pt, digits):
    """sum_i s_i P_i over G1 by the windowed Pippenger method at the
    reference's 8-bit windows: pt = (X, Y, Z), each [n, 32] int64
    Jacobian Montgomery limbs, n >= 1; digits [32, n] (any integer dtype,
    values below 256), window 0 most significant (ops/msm.py
    `_digits_np`).  Returns one Jacobian point (X, Y, Z), each [32], whose
    affine coordinates equal the plain version's; its Jacobian words
    depend on the order of additions, which differs.

    On CUDA tensors the five launches of csrc/bls381_pippenger.cu
    (bucketing, chunk sums, bucket trees, bit trees, Horner), each
    counted, on scratch allocated here (`pippenger_scratch`).  On CPU
    tensors the plain version (ops/msm.py `_pippenger_g1`), the points
    padded with infinity (digit 0) to a multiple of its PIPPENGER_LANES
    bucket-table lanes."""
    X = pt[0]
    for name, t in zip("XYZ", pt):
        _check(f"pippenger_g1 {name}", t, (32,), torch.int64, X.device)
        if t.shape != X.shape or t.dim() != 2:
            raise ValueError(f"pippenger_g1: expected [n, 32] coordinates, "
                             f"got {tuple(t.shape)}")
    n = X.shape[0]
    if n < 1:
        raise ValueError("pippenger_g1: no points")
    if digits.shape != (PIPPENGER_WINDOWS, n) or digits.device != X.device:
        raise ValueError(f"pippenger_g1: expected digits "
                         f"[{PIPPENGER_WINDOWS}, {n}] on {X.device}, got "
                         f"{tuple(digits.shape)} on {digits.device}")
    if X.device.type == "cpu":
        pippenger_g1.plain_calls += 1
        from . import msm
        pad = -n % PIPPENGER_LANES
        if pad:
            inf = curve_torch.point_infinity_like(
                F1, tuple(c[:1] for c in pt))
            pt = tuple(torch.cat([c, i.expand(pad, -1)])
                       for c, i in zip(pt, inf))
            digits = torch.cat(
                [digits, digits.new_zeros((PIPPENGER_WINDOWS, pad))], dim=1)
        return msm._pippenger_g1(*pt, digits)
    kernels = cuda_build.build()
    words = _words(torch.stack(pt, dim=1))            # [n, 3, 12]
    d8 = digits.to(torch.uint8).contiguous()
    scratch = pippenger_scratch(n, X.device)
    kernels.pippenger(words, d8, n, *scratch.values(), 0)
    pippenger_g1.launches += PIPPENGER_LAUNCHES
    return tuple(fq.from_words(scratch["out"]).unbind(0))


PIPPENGER_WINDOWS = 32
PIPPENGER_LANES = 16             # the plain version's lanes (ops/msm.py)
PIPPENGER_CHUNK = 16            # csrc/bls381_pippenger.cu kChunk
PIPPENGER_LAUNCHES = 5          # launches of one pippenger_g1 call
pippenger_g1.launches = 0
pippenger_g1.plain_calls = 0

# every wrapper of the BLS kernels, by kernel name (chip_smoke.py reads
# and resets their counts); K1 sits in csrc/bls381_check.cu
WRAPPERS = {"bls381_pairing": (miller, product_final),
            "bls381_g2": (g2_ladder,), "bls381_field": (field_op,),
            "bls381_segment_sum": (segment_sum,),
            "bls381_g1_ladder": (g1_ladder,), "bls381_fold": (fold_lanes,),
            "bls381_cofactor": (clear_cofactor_g2,),
            "bls381_check": (pairing_check,),
            "bls381_pippenger": (pippenger_g1,)}
