"""Pluggable BLS backend shim: the spec's signature seam.

Counterpart of consensus_specs_tpu/utils/bls.py (itself modelled on the
consensus-specs eth2spec.utils.bls): a module-global backend switched at
run time, a `bls_active` flag that lets a harness stub signature checks, and
the spec-facing API (Sign, Verify, Aggregate, FastAggregateVerify,
AggregateVerify, AggregatePKs, SkToPk, KeyValidate) with the low-level
curve ops and conversions.

Backends:

- "cuda", the default: ops/bls_cuda.py, the device ladder and pairing
  kernels on `consensus_specs_tpu_torch.get_device()` (the card, or the
  plain torch versions after `set_device("cpu")`).  "tpu" and "fastest"
  are accepted as its aliases, so modules written for the reference bind
  unchanged.
- "native": the pure-Python suite (crypto/bls12_381.py), the opt-in oracle.

Unlike the reference there is no resilience dispatch: no supervisor, no
fault injection and no native fallback around a device call.  A device
failure raises; the device backend never substitutes the oracle.  A decode
failure is a False verdict on both backends, as in the reference.
`multi_exp` of MULTI_EXP_DEVICE_THRESHOLD points or more runs on the device
backend's MSMs (ops/msm.py), the oracle below it and on "native".
"""
from __future__ import annotations

import functools

# global switches
bls_active = True
_backend_name = "cuda"

STUB_SIGNATURE = b"\x11" * 96
STUB_PUBKEY = b"\x22" * 48
STUB_COORDINATES = (0, 0)

_ALIASES = {"cuda": "cuda", "tpu": "cuda", "fastest": "cuda",
            "native": "native"}


def use_backend(name: str) -> None:
    global _backend_name
    if name not in _ALIASES:
        raise ValueError(f"unknown bls backend {name!r}")
    _backend_name = _ALIASES[name]


def use_native() -> None:
    use_backend("native")


def current_backend() -> str:
    return _backend_name


def only_with_bls(alt_return=None):
    """Decorator: skip the wrapped function when bls is disabled."""
    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not bls_active:
                return alt_return
            return fn(*args, **kwargs)
        return wrapper
    return decorator


def _native():
    from ..crypto import bls12_381 as n
    return n


def _device():
    from ..ops import bls_cuda as d
    return d


# --- signature API ---------------------------------------------------------

class _Memo:
    """Bounded FIFO memo over pure primitives (sign and the native verify
    oracle are functions of their byte inputs, nothing else): tests that
    rebuild identical blocks re-derive identical signatures and verdicts,
    at about 30 ms a Sign and 200 ms a native pairing check.  The device
    backend is not memoized: every call reaches the kernels."""

    _MISS = object()

    def __init__(self, cap: int = 1 << 14):
        self._store: dict = {}
        self._cap = cap

    def get(self, key, compute):
        hit = self._store.get(key, self._MISS)
        if hit is not self._MISS:
            return hit
        value = compute()
        if len(self._store) >= self._cap:
            self._store.pop(next(iter(self._store)))
        self._store[key] = value
        return value


_SIGN_MEMO = _Memo()
_VERIFY_MEMO = _Memo()


def _native_verify(PK, message, signature):
    key = ("v", bytes(PK), bytes(message), bytes(signature))

    def compute():
        try:
            return _native().Verify(key[1], key[2], key[3])
        except ValueError:
            return False
    return _VERIFY_MEMO.get(key, compute)


def _native_aggregate_verify(pubkeys, messages, signature):
    key = ("av", tuple(bytes(pk) for pk in pubkeys),
           tuple(bytes(m) for m in messages), bytes(signature))

    def compute():
        try:
            return _native().AggregateVerify(
                list(key[1]), list(key[2]), key[3])
        except ValueError:
            return False
    return _VERIFY_MEMO.get(key, compute)


def _native_fast_aggregate_verify(pubkeys, message, signature):
    key = ("fav", tuple(bytes(pk) for pk in pubkeys), bytes(message),
           bytes(signature))

    def compute():
        try:
            return _native().FastAggregateVerify(
                list(key[1]), key[2], key[3])
        except ValueError:
            return False
    return _VERIFY_MEMO.get(key, compute)


@only_with_bls(alt_return=True)
def Verify(PK, message, signature):
    if _backend_name == "cuda":
        return _device().Verify(bytes(PK), bytes(message), bytes(signature))
    return _native_verify(PK, message, signature)


@only_with_bls(alt_return=True)
def AggregateVerify(pubkeys, messages, signature):
    if _backend_name == "cuda":
        return _device().AggregateVerify(
            [bytes(pk) for pk in pubkeys], [bytes(m) for m in messages],
            bytes(signature))
    return _native_aggregate_verify(pubkeys, messages, signature)


@only_with_bls(alt_return=True)
def FastAggregateVerify(pubkeys, message, signature):
    if _backend_name == "cuda":
        return _device().FastAggregateVerify(
            [bytes(pk) for pk in pubkeys], bytes(message), bytes(signature))
    return _native_fast_aggregate_verify(pubkeys, message, signature)


# --- batched verification (a block's worth of checks in one device call) --

def _pk_bytes(pk):
    """Batch APIs accept compressed bytes or decompressed curve Points (the
    pubkey-cache shape); normalize for the byte-level native suite."""
    if hasattr(pk, "is_infinity"):
        return _native().G1_to_bytes48(pk)
    return bytes(pk)


def _sig_bytes(sig):
    if hasattr(sig, "is_infinity"):
        return _native().G2_to_bytes96(sig)
    return bytes(sig)


def _batch(n_jobs, device_fn, native_fn):
    """Shared batch contract: with bls disabled every job reads as valid
    (the scalar APIs' stub-True semantics); the device backend runs the
    whole batch as one ladder and one pairing dispatch, the native backend
    job by job."""
    if not bls_active:
        return [True] * n_jobs
    return device_fn() if _backend_name == "cuda" else native_fn()


def FastAggregateVerifyBatch(pubkey_lists, messages, signatures):
    """Verdict list for many FastAggregateVerify jobs."""
    return _batch(
        len(pubkey_lists),
        lambda: _device().fast_aggregate_verify_batch(
            pubkey_lists, messages, signatures),
        lambda: [_native_fast_aggregate_verify(
                     [_pk_bytes(pk) for pk in pks], m, _sig_bytes(s))
                 for pks, m, s in zip(pubkey_lists, messages, signatures)])


def VerifyBatch(pubkeys, messages, signatures):
    """Verdict list for many independent Verify jobs."""
    return _batch(
        len(pubkeys),
        lambda: _device().verify_batch(pubkeys, messages, signatures),
        lambda: [_native_verify(_pk_bytes(pk), m, _sig_bytes(s))
                 for pk, m, s in zip(pubkeys, messages, signatures)])


def AggregateVerifyBatch(pubkey_lists, message_lists, signatures):
    """Verdict list for many AggregateVerify jobs (distinct message a
    pubkey within each job)."""
    return _batch(
        len(pubkey_lists),
        lambda: _device().aggregate_verify_batch(
            pubkey_lists, message_lists, signatures),
        lambda: [_native_aggregate_verify(
                     [_pk_bytes(pk) for pk in pks], ms, _sig_bytes(s))
                 for pks, ms, s in zip(pubkey_lists, message_lists,
                                       signatures)])


@only_with_bls(alt_return=STUB_SIGNATURE)
def Aggregate(signatures):
    return _native().Aggregate([bytes(s) for s in signatures])


@only_with_bls(alt_return=STUB_SIGNATURE)
def Sign(SK, message):
    key = (int(SK), bytes(message))
    return _SIGN_MEMO.get(key, lambda: _native().Sign(key[0], key[1]))


@only_with_bls(alt_return=STUB_PUBKEY)
def AggregatePKs(pubkeys):
    return _native().AggregatePKs([bytes(pk) for pk in pubkeys])


@only_with_bls(alt_return=STUB_PUBKEY)
def SkToPk(SK):
    return _native().SkToPk(int(SK))


def KeyValidate(pubkey) -> bool:
    return _native().KeyValidate(bytes(pubkey))


# --- low-level curve API ---------------------------------------------------

def add(lhs, rhs):
    return _native().add(lhs, rhs)


def multiply(point, scalar):
    return _native().multiply(point, scalar)


def neg(point):
    return _native().neg(point)


# minimum batch size for device MSM dispatch: below this the per-call
# transfer and launches dwarf the host Pippenger cost
MULTI_EXP_DEVICE_THRESHOLD = 128


def multi_exp(points, integers):
    """Multi-scalar multiplication over G1 or G2 points (the reference's
    arkworks multiexp slot).  The device backend routes batches of
    MULTI_EXP_DEVICE_THRESHOLD points or more through the device MSMs,
    G1 through ops/msm.g1_multi_exp and G2 through ops/msm.g2_multi_exp,
    with no host fallback; smaller batches and the native backend take the
    oracle."""
    if _backend_name == "cuda" and len(points) >= MULTI_EXP_DEVICE_THRESHOLD:
        from ..crypto import curve as cv
        from ..ops import msm as device_msm
        first = points[0]
        if isinstance(first, cv.Point):
            if isinstance(first.x, cv.Fq1):
                return device_msm.g1_multi_exp(points, integers)
            return device_msm.g2_multi_exp(points, integers)
    return _native().multi_exp(points, integers)


def pairing_check(values) -> bool:
    """Combined pairing-product check over (G1, G2) Point pairs: the
    device kernels on the device backend, the oracle on native."""
    if _backend_name == "cuda":
        return _device().pairing_check_points(values)
    return _native().pairing_check(values)


def G1_to_bytes48(point) -> bytes:
    return _native().G1_to_bytes48(point)


def bytes48_to_G1(b):
    return _native().bytes48_to_G1(bytes(b))


def G2_to_bytes96(point) -> bytes:
    return _native().G2_to_bytes96(point)


def bytes96_to_G2(b):
    return _native().bytes96_to_G2(bytes(b))


def Z1():
    return _native().Z1()


def Z2():
    return _native().Z2()


def G1():
    return _native().G1()


def G2():
    return _native().G2()
