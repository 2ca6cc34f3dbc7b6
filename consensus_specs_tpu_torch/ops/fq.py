"""BLS12-381 base field Fq in torch: the plain version of the limb arithmetic.

Counterpart of consensus_specs_tpu/ops/fq.py, with its names and constants:
an Fq element is 32 limbs x 12 bits, little-endian, batched over leading
axes, in Montgomery form (R = 2^384 mod q) and canonical (< q) between ops.
The limbs are held in int64: torch on the CPU has no uint32 shifts or adds,
and the headroom lets a product's coefficient sums (< 2^50) stay exact.

What differs from the reference is how, not what: every op returns the same
canonical limbs.

- Carries resolve with a few shift-add compaction rounds (as many as the
  input's limb bound needs) and, where a limb still holds 2^12, one
  carry-lookahead done as a running maximum (`_norm`), in place of the
  reference's Kogge-Stone steps.
- `add`/`sub` normalize the plain and the q-shifted result side by side and
  pick one by the top bit, so each costs one normalization.
- Products are polynomial products summed along the anti-diagonals of
  the outer product in int64 (a strided copy and one sum, no matrix
  product: torch has no int64 matrix product on the card), and `mul`
  folds the final conditional subtract into the reduction's
  normalization.

The CUDA kernels (ops/csrc/bls381.cuh) hold an Fq element as 12 x 32-bit
words; `to_words`/`from_words` repack between the layouts.  Both have
R = 2^384, so the Montgomery integers are the same.

The pure-Python tower (crypto/fields.py) is the oracle; tests hold every op
here against it and against the reference's limbs.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..crypto.fields import Q

# ---------------------------------------------------------------------------
# representation constants
# ---------------------------------------------------------------------------

LIMB_BITS = 12
LIMBS = 32            # 32 * 12 = 384 bits >= 381
BASE = 1 << LIMB_BITS
MASK = BASE - 1
WORDS = 12            # the kernels' 32-bit words

R_MONT = pow(2, LIMB_BITS * LIMBS, Q)          # Montgomery radix R mod q
R2_MONT = R_MONT * R_MONT % Q                  # R^2 mod q (to-Mont factor)


def _int_to_limbs_np(x: int) -> np.ndarray:
    return np.array([(x >> (LIMB_BITS * i)) & MASK for i in range(LIMBS)],
                    dtype=np.int64)


Q_LIMBS = _int_to_limbs_np(Q)
R2_LIMBS = _int_to_limbs_np(R2_MONT)
ONE_MONT_LIMBS = _int_to_limbs_np(R_MONT)      # 1 in Montgomery form
ZERO_LIMBS = np.zeros(LIMBS, dtype=np.int64)
# 2^384 - q: adding it subtracts q under a +2^384 bias
_QCOMP_LIMBS = _int_to_limbs_np((1 << (LIMB_BITS * LIMBS)) - Q)
# (2^384 - 1) + 1 at limb 0: a + (this - b) == a - b + 2^384
_MASK_PLUS_ONE = np.full(LIMBS, MASK, dtype=np.int64)
_MASK_PLUS_ONE[0] += 1
# 2q with every limb below the top >= 2^12 - 1: a - b + TWO_Q_SPREAD has
# no negative limb for canonical a, b (a raw difference for `mul`)
_2Q = _int_to_limbs_np(2 * Q)
TWO_Q_SPREAD = _2Q + np.array([4096] + [4095] * 30 + [-1], dtype=np.int64)
# full-width -q^{-1} mod 2^384
_NINV_FULL = (-pow(Q, -1, 1 << (LIMB_BITS * LIMBS))) % \
    (1 << (LIMB_BITS * LIMBS))


_NINV_LIMBS = _int_to_limbs_np(_NINV_FULL)
# q * 2^384 subtracted from the reduction's sum under a 2^768 bias: the
# limbs of 2^768 - q * 2^384 from limb 32 up
_QCOMP_HI = np.concatenate([np.zeros(LIMBS, np.int64), _QCOMP_LIMBS])

_consts: dict = {}


def _const(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """`arr` as a tensor on `like`'s device (cached per array and device)."""
    key = (id(arr), like.device)
    t = _consts.get(key)
    if t is None:
        t = _consts[key] = torch.from_numpy(arr).to(like.device)
    return t


# ---------------------------------------------------------------------------
# host codecs
# ---------------------------------------------------------------------------

def to_limbs(x: int, device="cpu") -> torch.Tensor:
    """Plain integer -> canonical (non-Montgomery) limb vector."""
    return torch.from_numpy(_int_to_limbs_np(x % Q)).to(device)


def from_limbs(v) -> int:
    arr = np.asarray(torch.as_tensor(v).cpu(), dtype=np.int64)
    out = 0
    for i in reversed(range(arr.shape[-1])):
        out = (out << LIMB_BITS) | int(arr[..., i])
    return out


def pack(xs, device="cpu") -> torch.Tensor:
    """List of ints -> batched canonical limb array [n, LIMBS]."""
    return torch.from_numpy(
        np.stack([_int_to_limbs_np(x % Q) for x in xs])).to(device)


def unpack(v) -> list:
    arr = torch.as_tensor(v).cpu()
    return [from_limbs(arr[i]) for i in range(arr.shape[0])]


def pack_mont(xs, device="cpu") -> torch.Tensor:
    """List of ints -> [n, LIMBS] Montgomery limbs."""
    return torch.from_numpy(np.stack(
        [_int_to_limbs_np(x % Q * R_MONT % Q) for x in xs])).to(device)


def unpack_mont(v) -> list:
    """[n, LIMBS] Montgomery limbs -> list of ints (on the host, exact)."""
    r_inv = pow(R_MONT, -1, Q)
    return [x * r_inv % Q for x in unpack(v)]


# ---------------------------------------------------------------------------
# normalization helpers (batched over leading axes, branch-free)
# ---------------------------------------------------------------------------

def _shift_limbs(x, d):
    """x[..., i] -> x[..., i-d] (little-endian shift toward the top),
    zero-filled."""
    return F.pad(x[..., :-d], (d, 0))


def _compact(t, rounds):
    """Partial carry compaction modulo 2^(12 * width): `rounds` shift-add
    passes over [..., width] int64 limbs (>= 0) that drop the top limb's
    carry, so the value changes by exact multiples of 2^(12 * width)
    (`mul` uses that for its mod-R arithmetic).  A limb bound B becomes
    MASK + B // 2^12 after a round."""
    for _ in range(rounds):
        t = (t & MASK) + _shift_limbs(t >> LIMB_BITS, 1)
    return t


def _rounds(t, rounds):
    """`rounds` compaction rounds of limbs whose width covers the value:
    the top limb's carry is zero, so the shift may rotate."""
    for _ in range(rounds):
        t = (t & MASK) + torch.roll(t >> LIMB_BITS, 1, -1)
    return t


# the lookahead's codes 2j + 2 of limb j, for the widths normalized here
_LOOKAHEAD_BASE = {w: np.arange(2, 2 * w + 2, 2, dtype=np.int64)
                   for w in (LIMBS + 1, 2 * LIMBS + 2)}


def _norm(t, rounds=3):
    """Exact carry normalization: [..., w] int64 limbs (>= 0) whose width
    covers the value -> canonical 12-bit limbs of the same integer.
    `rounds` compaction rounds must bring every limb to <= 2^12 (the
    caller knows its bound).

    A limb left at 2^12 ripples a +1 upward.  Where any does, the ripple
    resolves in one pass: the carry out of limb j is the generate bit
    (limb == 2^12) of the last limb at or below j that does not propagate
    (limb != 2^12 - 1), found by a running maximum over codes 2j + 2 +
    generate (0 where the limb propagates).  The top limb's carry is
    zero, so the shift may rotate."""
    t = _rounds(t, rounds)
    if not bool((t > MASK).any()):
        return t
    code = torch.where(t == MASK, 0,
                       _const(_LOOKAHEAD_BASE[t.shape[-1]], t)
                       + (t >> LIMB_BITS))
    carry_out = torch.cummax(code, dim=-1).values & 1
    return ((t & MASK) + torch.roll(carry_out, 1, -1)) & MASK


def _csub_q(a):
    """Conditionally subtract q when a >= q (a < 2q, canonical limbs in
    and out): a + (2^384 - q) overflows into limb 32 exactly when
    a >= q."""
    t = _norm(F.pad(a + _const(_QCOMP_LIMBS, a), (0, 1)), 2)
    return torch.where(t[..., LIMBS:] > 0, t[..., :LIMBS], a)


def _pick_biased(plain, biased):
    """Normalize (plain, biased) side by side (both [..., LIMBS] with limb
    bound < 2^14, biased = plain + 2^384 - c for some c) and return
    biased's low limbs where it reached 2^384, else plain's."""
    both = _norm(F.pad(torch.stack([plain, biased]), (0, 1)), 2)
    return torch.where(both[1, ..., LIMBS:] > 0, both[1],
                       both[0])[..., :LIMBS]


# ---------------------------------------------------------------------------
# field ops (Montgomery domain unless stated)
# ---------------------------------------------------------------------------

def add(a, b):
    """(a + b) mod q: a + b, or a + b - q when a + b >= q."""
    s = a + b
    return _pick_biased(s, s + _const(_QCOMP_LIMBS, s))


def sub(a, b):
    """(a - b) mod q: a - b + q, or a - b when a >= b (under the 2^384
    bias, the complement turns the borrow chain into the carry chain)."""
    d = a + (_const(_MASK_PLUS_ONE, a) - b)        # a - b + 2^384
    return _pick_biased(d + _const(Q_LIMBS, d), d)


def neg(a):
    """-a mod q (Montgomery form preserved); -0 = 0."""
    return sub(torch.zeros_like(a), a)


def _conv(a, b):
    """Schoolbook product coefficients [..., 2*LIMBS-1] in int64: the outer
    product a_i b_j written into a zeroed [32, 63] row with row stride 64
    (so a_i b_j lands in column i + j) and summed over the rows.  No
    matrix product: exact, and the same on the CPU and the card."""
    outer = (a.unsqueeze(-1) * b.unsqueeze(-2)).reshape(-1, LIMBS, LIMBS)
    n = outer.shape[0]
    skew = torch.zeros((n, LIMBS * (2 * LIMBS - 1)), dtype=torch.int64,
                       device=outer.device)
    skew.as_strided((n, LIMBS, LIMBS),
                    (LIMBS * (2 * LIMBS - 1), 2 * LIMBS, 1)).copy_(outer)
    return skew.view(n, LIMBS, 2 * LIMBS - 1).sum(1).reshape(
        *a.shape[:-1], 2 * LIMBS - 1)


def mul(a, b):
    """Montgomery product a * b * R^{-1} mod q, canonical.

    Takes canonical operands, and also the unreduced sums the tower feeds
    it (limbs < 2^14, a * b < 6q^2: a limbwise sum of two canonical values
    times a difference raised by `TWO_Q_SPREAD`).  REDC in base 2^12, full
    width: m = (T mod R) * (-q^{-1}) mod R in one truncated product
    (coefficient sums < 2^50), four compaction rounds
    (m's limbs <= 4097, so m < 1.001 R), then (T + m*q) / R < 2q.  That
    sum is normalized side by side with itself minus q * 2^384 (biased by
    2^768), so the conditional subtract costs no second normalization."""
    a, b = torch.broadcast_tensors(a, b)
    mul.count += a.numel() // LIMBS
    t = _conv(a, b)
    m = _compact(_conv(t[..., :LIMBS], _const(_NINV_LIMBS, a).expand(
        a.shape))[..., :LIMBS], 4)
    s = _conv(m, _const(Q_LIMBS, a).expand(a.shape))
    total = F.pad(t + s, (0, 2))                      # 65 limbs
    both = torch.stack([total, total + F.pad(_const(_QCOMP_HI, a), (0, 1))])
    both = _norm(F.pad(both, (0, 1)), 3)
    return torch.where(both[1, ..., 2 * LIMBS:2 * LIMBS + 1] > 0,
                       both[1], both[0])[..., LIMBS:2 * LIMBS]


mul.count = 0   # Fq products computed (for the kernels' operation bounds)


def square(a):
    return mul(a, a)


def to_mont(a):
    """Canonical limbs -> Montgomery form."""
    return mul(a, _const(R2_LIMBS, a).expand(a.shape))


def from_mont(a):
    """Montgomery form -> canonical limbs (multiply by 1)."""
    one = torch.zeros_like(a)
    one[..., 0] = 1
    return mul(a, one)


def is_zero(a):
    return torch.all(a == 0, dim=-1)


def eq(a, b):
    return torch.all(a == b, dim=-1)


def select(cond, a, b):
    """cond ? a : b, broadcasting cond over the limb axis."""
    return torch.where(cond[..., None], a, b)


def zeros_like(a):
    return torch.zeros_like(a)


def one_mont(shape_like):
    """1 in Montgomery form, broadcast to shape_like's batch shape."""
    return _const(ONE_MONT_LIMBS, shape_like).expand(shape_like.shape)


# ---------------------------------------------------------------------------
# the kernels' word layout
# ---------------------------------------------------------------------------

def to_words(limbs: torch.Tensor) -> torch.Tensor:
    """[..., 32] 12-bit limbs -> [..., 12] int32 words (uint32 bit
    patterns), little-endian: 8 limbs make 3 words."""
    g = limbs.reshape(*limbs.shape[:-1], 4, 8)
    l0, l1, l2, l3, l4, l5, l6, l7 = g.unbind(-1)
    w = torch.stack([
        l0 | (l1 << 12) | ((l2 & 0xFF) << 24),
        (l2 >> 8) | (l3 << 4) | (l4 << 16) | ((l5 & 0xF) << 28),
        (l5 >> 4) | (l6 << 8) | (l7 << 20)], dim=-1)
    w = w - ((w >> 31) << 32)                          # to int32's range
    return w.reshape(*limbs.shape[:-1], WORDS).to(torch.int32)


def from_words(words: torch.Tensor) -> torch.Tensor:
    """[..., 12] int32 words -> [..., 32] int64 12-bit limbs."""
    w = (words.to(torch.int64) & 0xFFFFFFFF).reshape(*words.shape[:-1], 4, 3)
    w0, w1, w2 = w.unbind(-1)
    limbs = torch.stack([
        w0 & MASK, (w0 >> 12) & MASK, (w0 >> 24) | ((w1 & 0xF) << 8),
        (w1 >> 4) & MASK, (w1 >> 16) & MASK, (w1 >> 28) | ((w2 & 0xFF) << 4),
        (w2 >> 8) & MASK, (w2 >> 20) & MASK], dim=-1)
    return limbs.reshape(*words.shape[:-1], LIMBS)
