"""Device multi-scalar multiplications: the KZG engine's MSM and the
signature flush's scalar multiplications.

Counterpart of consensus_specs_tpu/ops/msm.py:

- `g1_multi_exp(points, scalars)`: sum_i s_i P_i over G1, the KZG engine's
  device MSM (crypto/kzg.py g1_lincomb, sigpipe/fold.py
  `fold_kzg_lincombs`) and the BLS shim's `multi_exp`.  Two engines, split
  by the device as the reference's are by the jax backend: on the card at
  n >= `_PIPPENGER_MIN` the windowed Pippenger MSM (the kernel
  ops/csrc/bls381_pippenger.cu through `bls381_cuda.pippenger_g1`);
  otherwise, and always on the CPU, the lanes engine, the G1 ladder
  (ops/csrc/bls381_msm.cu, K2) over rows split by GLV (two 128-bit halves
  a scalar, curve_torch.glv_bits) and one segment sum (K1) in the halving
  order of the reference's `_tree_sum_host`.  The plain Pippenger
  `_pippenger_g1` is the kernel's reference version;
- `g1_weighted_sweep(points, scalars)`: the per-pair weighted points
  [s_i P_i], no reduction: the Fiat-Shamir weighting of a flush's
  aggregates (sigpipe/scheduler.py), one G1 ladder launch
  (ops/csrc/bls381_msm.cu, K2) over 64-bit bit rows when every scalar fits
  in 64 bits, rows split by GLV otherwise (the reference's 256-bit rows);
- `g2_multi_exp(points, scalars)`: sum_i s_i P_i over G2, the folded
  signature sum of a staged flush (sigpipe/fold.py): the G2 ladder
  (ops/csrc/bls381_g2.cu) over the same bit rows, then one segment sum
  (K1, ops/csrc/bls381_check.cu) over the ladder's outputs, in the
  reference's halving order.

All run on the device of `consensus_specs_tpu_torch.get_device()`, the
kernels on the card and their plain versions on the CPU; scalars are
reduced mod r first, as in the reference: every input point lies in the
r-torsion subgroup, which the GLV split needs too.  The callers' points
passed a subgroup check: the flush's aggregates are sums of pubkeys that
sigpipe/cache.py decodes with one, the KZG batch verify's proofs and
commitments pass `validate_kzg_g1` before `fold_kzg_lincombs`, and
crypto/kzg.py's `g1_lincomb` takes the ceremony's setup points, which
the setup puts in G1; the BLS shim's `multi_exp` (utils/bls.py), whose
points come from `bytes48_to_G1` without a check, keeps unsplit rows
(`glv=False`).
The reference's mesh sharding of the ladder axis is not ported (ROADMAP
A8).
"""
from __future__ import annotations

import numpy as np
import torch

from ..crypto import curve as cv
from ..crypto.fields import R
from . import bls381_cuda, curve_torch
from .g1_sweep import _device, _pow2

# ---------------------------------------------------------------------------
# windowed Pippenger (plain version of csrc/bls381_pippenger.cu)
# ---------------------------------------------------------------------------

_W_BITS = 8                     # window width
_N_WIN = 256 // _W_BITS         # 32 windows cover the 255-bit scalar
_N_BUCKETS = (1 << _W_BITS) - 1  # bucket 0 contributes nothing
_THREADS = 16                   # bucket-table lanes per window
_PIPPENGER_MIN = 256            # below this the lanes engine runs


def _digits_np(scalars, w_bits: int = _W_BITS) -> np.ndarray:
    """[256 // w_bits, n] uint32 window digits of scalars below 2^256,
    window 0 most significant."""
    raw = b"".join(int(s).to_bytes(32, "big") for s in scalars)
    bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8))
    bits = bits.reshape(len(scalars), 256 // w_bits, w_bits)
    weights = (1 << np.arange(w_bits - 1, -1, -1)).astype(np.uint32)
    return np.ascontiguousarray((bits.astype(np.uint32) @ weights).T)


def _pippenger_g1(X, Y, Z, digits, *, w_bits: int = _W_BITS,
                  threads: int = _THREADS):
    """MSM over G1: X/Y/Z [n, 32] Jacobian Montgomery limbs, digits
    [256 // w_bits, n] (window 0 most significant), n a multiple of
    `threads`.  Returns one Jacobian point (X, Y, Z), each [32].

    The reference's order of additions, so its Jacobian words: lane
    (w, t) folds points t * chunk + j, j = 0, 1, ..., into bucket
    digit[w][i] of its table (the current bucket first); log2(threads)
    rounds add lane t + h into lane t; two suffix scans of
    ceil(log2(buckets)) rounds turn the bucket sums into the window's
    weighted sum at position 0; Horner over the windows.  The merge and
    scan rounds compute only the lanes the reference's selects keep (its
    discarded masked adds change nothing)."""
    F = curve_torch.F1
    n = X.shape[0]
    n_win = 256 // w_bits
    n_buckets = (1 << w_bits) - 1
    if n % threads or digits.shape != (n_win, n):
        raise ValueError(f"_pippenger_g1: {n} points and digits "
                         f"{tuple(digits.shape)} for {threads} lanes of "
                         f"{n_win} windows")
    chunk = n // threads
    inf = curve_torch.point_infinity_like(F, (X[:1], Y[:1], Z[:1]))
    # [W, T, buckets + 1, 32] private bucket tables (slot 0 = dump for
    # digit 0)
    tables = [c.reshape(1, 1, 1, -1).expand(
        n_win, threads, n_buckets + 1, -1).clone() for c in inf]
    pts = [c.reshape(threads, chunk, -1) for c in (X, Y, Z)]
    dc = digits.to(device=X.device, dtype=torch.int64).reshape(
        n_win, threads, chunk)
    w_idx = torch.arange(n_win, device=X.device)[:, None]
    t_idx = torch.arange(threads, device=X.device)[None, :]
    for j in range(chunk):
        d = dc[:, :, j]                                   # [W, T]
        cur = tuple(c[w_idx, t_idx, d] for c in tables)
        new = curve_torch.point_add(
            F, cur, tuple(c[:, j].expand(n_win, -1, -1) for c in pts))
        keep = d > 0
        for c, nw, cu in zip(tables, new, cur):
            c[w_idx, t_idx, d] = F.select(keep, nw, cu)
    # merge the lane tables: round h = T/2, ..., 1 adds lane t + h into t
    P = tuple(c[:, :, 1:] for c in tables)
    h = threads // 2
    while h >= 1:
        head = curve_torch.point_add(F, tuple(c[:, :h] for c in P),
                                     tuple(c[:, h:2 * h] for c in P))
        P = tuple(torch.cat([a, c[:, h:]], dim=1) for a, c in zip(head, P))
        h //= 2
    S = tuple(c[:, 0] for c in P)                        # [W, buckets]
    # two suffix scans: P[i] += P[i + shift] where i + shift < buckets,
    # every lane reading the round's old values
    rounds = (n_buckets - 1).bit_length()
    for _scan in range(2):
        for r in range(rounds):
            m = n_buckets - (1 << r)
            head = curve_torch.point_add(F, tuple(c[:, :m] for c in S),
                                         tuple(c[:, 1 << r:] for c in S))
            S = tuple(torch.cat([a, c[:, m:]], dim=1)
                      for a, c in zip(head, S))
    G = tuple(c[:, 0] for c in S)                        # [W, 32]
    acc = tuple(c[0] for c in inf)
    for w in range(n_win):
        for _i in range(w_bits):
            acc = curve_torch.point_double(F, acc)
        acc = curve_torch.point_add(F, acc, tuple(c[w] for c in G))
    return acc


def _pippenger_inputs(points, scalars, device, w_bits: int = _W_BITS,
                      threads: int | None = None):
    """The Pippenger engine's inputs: the points packed on `device` and
    their digits [256 // w_bits, m] (uint8), m = n.  With `threads` (the
    plain version's lanes) the points are padded with infinity (and the
    scalars with 0) to a power of two that is a multiple of `threads`, as
    the reference pads them."""
    n = len(points)
    m = _pow2(-(-n // threads) * threads) if threads else n
    pts = list(points) + [cv.g1_infinity()] * (m - n)
    sc = [int(s) % R for s in scalars] + [0] * (m - n)
    digits = _digits_np(sc, w_bits).astype(np.uint8)
    return (curve_torch.g1_pack(pts, device),
            torch.from_numpy(digits).to(device))


def g1_multi_exp(points, scalars, *, glv: bool = True):
    """sum_i scalars[i] * points[i] over G1; returns an oracle Point.

    On the card at n >= _PIPPENGER_MIN: the Pippenger MSM over the n
    points as they are, one `bls381_cuda.pippenger_g1` call.  Otherwise the lanes
    engine: one G1 ladder over rows split by GLV (256-bit rows with
    `glv=False`, for points not known to lie in G1), the points padded to
    a power of two, then one segment sum in the halving order of the
    reference's `_tree_sum_host`."""
    if len(points) != len(scalars):
        raise ValueError("g1_multi_exp: length mismatch")
    if not points:
        return cv.g1_infinity()
    n = len(points)
    device = _device()
    if n >= _PIPPENGER_MIN and device.type != "cpu":
        out = bls381_cuda.pippenger_g1(
            *_pippenger_inputs(points, scalars, device))
        return curve_torch.g1_unpack(tuple(c.cpu()[None] for c in out))[0]
    m = _pow2(n)
    pts = list(points) + [cv.g1_infinity()] * (m - n)
    sc = [int(s) % R for s in scalars] + [0] * (m - n)
    bits = curve_torch.glv_bits(sc, device) if glv else \
        curve_torch.scalars_to_bits(sc, 256, device)
    prods = bls381_cuda.g1_ladder(curve_torch.g1_pack(pts, device), bits)
    total = bls381_cuda.segment_sum(tuple(c[None] for c in prods))
    return curve_torch.g1_unpack(tuple(c.cpu() for c in total))[0]


def _scalar_bits(scalars, device, glv: bool = True):
    """msb-first bit rows [n, 64] of the scalars when all fit in 64 bits,
    else [n, 256] (the reference's `n_bits` choice), or with `glv` rows
    split by GLV [n, 2, 128] in their place; uint8 on `device`."""
    width = max((s.bit_length() for s in scalars), default=1) or 1
    if width <= 64:
        return curve_torch.scalars_to_bits(scalars, 64, device)
    if glv:
        return curve_torch.glv_bits(scalars, device)
    return curve_torch.scalars_to_bits(scalars, 256, device)


def g1_weighted_sweep(points, scalars):
    """Per-pair weighted points [s_i * P_i] (oracle G1 Points), one
    ladder launch for the whole list."""
    if len(points) != len(scalars):
        raise ValueError("g1_weighted_sweep: length mismatch")
    if not points:
        return []
    device = _device()
    prods = bls381_cuda.g1_ladder(
        curve_torch.g1_pack(points, device),
        _scalar_bits([int(s) % R for s in scalars], device))
    return curve_torch.g1_unpack(tuple(c.cpu() for c in prods))


def g2_multi_exp(points, scalars):
    """sum_i scalars[i] * points[i] over G2; returns an oracle Point.  The
    ladder axis is padded to a power of two with infinity and scalar 0,
    as in the reference, for the halving sum."""
    if len(points) != len(scalars):
        raise ValueError("g2_multi_exp: length mismatch")
    if not points:
        return cv.g2_infinity()
    n = len(points)
    m = _pow2(n)
    pts = list(points) + [cv.g2_infinity()] * (m - n)
    sc = [int(s) % R for s in scalars] + [0] * (m - n)
    device = _device()
    prods = curve_torch.g2_scalar_mul(curve_torch.g2_pack(pts, device),
                                      _scalar_bits(sc, device, glv=False))
    total = bls381_cuda.segment_sum(tuple(c[None] for c in prods))
    return curve_torch.g2_unpack(tuple(c.cpu() for c in total))[0]
