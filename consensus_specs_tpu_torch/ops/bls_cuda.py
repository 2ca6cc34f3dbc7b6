"""Card-backed BLS verification: host decode, device ladder and pairing check.

Counterpart of consensus_specs_tpu/ops/bls_tpu.py.  The split is the
reference's: point decompression with subgroup checks, pubkey sums and
hash-to-field, SSWU and the isogeny run on the host over Python ints
(crypto/); the cofactor clearing h_eff P (ops/csrc/bls381_cofactor.cu, by
the psi endomorphism, affine in the same launch; the reference ran a
636-bit ladder and made its output affine on the host) and the batched
pairing check (ops/csrc/bls381_check.cu, one launch, four warps a job) run on
the device of `consensus_specs_tpu_torch.get_device()`, the CUDA card by
default.  With `set_device("cpu")` every device step runs its plain torch
version.

The API takes lists of verification jobs and returns a verdict a job, with
the reference's decode rules (a DecodeError or ValueError reads as an
invalid job) and its skip mask for infinity points (e(O, .) = 1).

What is left out, on purpose:

- the batch functions take only the reference's per-job branch, its
  behaviour under FOLD_VERIFY=0, whose verdicts equal the fold's by
  construction; the fold needs ops/msm.py and comes with the signature
  pipeline;
- the power-of-two padding of jobs and pairs, which only bounded XLA
  compiles: a job shorter than the batch's longest is padded with skipped
  pairs, nothing more;
- the mesh sharding of the hash batch (parallel/shard_verify.py).
"""
from __future__ import annotations

import numpy as np
import torch

import consensus_specs_tpu_torch as _port
from ..crypto import curve as cv
from ..crypto import hash_to_curve as h2c
from ..crypto.bls12_381 import _load_pubkey, _load_signature
from ..crypto.curve import DecodeError, Point
from ..sigpipe.metrics import METRICS
from . import bls381_cuda, cuda_build, curve_torch, fq, pairing_torch
from . import fq_tower as ft

# the bits of h_eff, msb-first: the fold's cofactor ladder walks them
_H_EFF_BITS = np.array([int(b) for b in bin(h2c.H_EFF)[2:]], dtype=np.uint8)


def _device() -> torch.device:
    return cuda_build.require_device(_port.get_device())


def hash_to_g2_batch(messages, dst=h2c.DST_G2):
    """Batched hash-to-curve: host hash-to-field, SSWU and isogeny, then one
    device launch for the cofactor clearing h_eff P with its affine result.
    Returns oracle Points (affine, Z = 1)."""
    if not messages:
        return []
    pre = []
    for msg in messages:
        u0, u1 = h2c.hash_to_field_fq2(bytes(msg), 2, dst)
        q0 = h2c.iso_map(*h2c.sswu_map(u0))
        q1 = h2c.iso_map(*h2c.sswu_map(u1))
        pre.append(q0 + q1)
    x, y, inf = bls381_cuda.clear_cofactor_g2(
        curve_torch.g2_pack(pre, _device()))
    xs, ys, inf = ft.fq2_unpack_mont(x), ft.fq2_unpack_mont(y), inf.tolist()
    one = cv.Fq2(1, 0)
    return [cv.g2_infinity() if i else Point(xa, ya, one, cv.B2)
            for xa, ya, i in zip(xs, ys, inf)]


def _resolve_pubkey(pk):
    """Accept compressed bytes or an already-validated Point (the spec's
    pubkey-cache shape)."""
    if isinstance(pk, Point):
        if pk.is_infinity():
            raise ValueError("infinity pubkey")
        return pk
    return _load_pubkey(bytes(pk))


def _resolve_signature(sig):
    if isinstance(sig, Point):
        return sig
    return _load_signature(bytes(sig))


def _affine_or_skip_g1(p):
    """(x_int, y_int, skip) — generator coords when p is infinity."""
    if p.is_infinity():
        xa, ya = cv.g1_generator().affine()
        return xa.v, ya.v, True
    xa, ya = p.affine()
    return xa.v, ya.v, False


def _affine_or_skip_g2(p):
    if p.is_infinity():
        xa, ya = cv.g2_generator().affine()
        return xa, ya, True
    xa, ya = p.affine()
    return xa, ya, False


def _run_pairing_checks(jobs):
    """jobs: list of lists of (G1 Point, G2 Point) pairs.  Returns np.bool_
    verdicts, one a job: one launch 1 and one launch 2 for the whole list.
    Jobs shorter than the longest are padded with skipped (O, O) pairs."""
    if not jobs:
        return np.zeros(0, dtype=bool)
    k = max(1, max(len(j) for j in jobs))
    xs1, ys1, xs2, ys2, skips = [], [], [], [], []
    for job in jobs:
        row = list(job) + [(cv.g1_infinity(), cv.g2_infinity())] \
            * (k - len(job))
        for p, q in row:
            x1, y1, s1 = _affine_or_skip_g1(p)
            x2, y2, s2 = _affine_or_skip_g2(q)
            xs1.append(x1)
            ys1.append(y1)
            xs2.append(x2)
            ys2.append(y2)
            skips.append(s1 or s2)
    device = _device()
    b = len(jobs)
    verdict = pairing_torch.pairing_check(
        fq.pack_mont(xs1, device).reshape(b, k, fq.LIMBS),
        fq.pack_mont(ys1, device).reshape(b, k, fq.LIMBS),
        ft.fq2_pack_mont(xs2, device).reshape(b, k, 2, fq.LIMBS),
        ft.fq2_pack_mont(ys2, device).reshape(b, k, 2, fq.LIMBS),
        torch.tensor(skips, dtype=torch.bool, device=device).reshape(b, k))
    return verdict.cpu().numpy()


# ---------------------------------------------------------------------------
# batched byte-level suite
# ---------------------------------------------------------------------------

def verify_batch(pubkeys, messages, signatures):
    """Batch of independent Verify(pk, msg, sig) jobs -> list[bool]."""
    prepared = []   # (slot, pk, msg, sig)
    results = [False] * len(pubkeys)
    neg_g1 = -cv.g1_generator()
    for i, (pk_b, msg, sig_b) in enumerate(
            zip(pubkeys, messages, signatures)):
        try:
            prepared.append((i, _resolve_pubkey(pk_b), bytes(msg),
                             _resolve_signature(sig_b)))
        except (DecodeError, ValueError):
            continue
    if not prepared:
        return results
    hashes = hash_to_g2_batch([p[2] for p in prepared])
    jobs = [[(pk, h), (neg_g1, sig)]
            for (_, pk, _, sig), h in zip(prepared, hashes)]
    for (i, *_), v in zip(prepared, _run_pairing_checks(jobs)):
        results[i] = bool(v)
    return results


def fast_aggregate_verify_batch(pubkey_lists, messages, signatures):
    """Batch of FastAggregateVerify jobs (shared message a job): each job's
    pubkeys summed on the host, then the exact per-job 2-pair check."""
    prepared = []   # (slot, agg, msg, sig)
    results = [False] * len(pubkey_lists)
    neg_g1 = -cv.g1_generator()
    for i, (pks, msg, sig_b) in enumerate(
            zip(pubkey_lists, messages, signatures)):
        if not len(pks):
            continue
        try:
            agg = cv.g1_infinity()
            for pk_b in pks:
                agg = agg + _resolve_pubkey(pk_b)
            prepared.append((i, agg, bytes(msg),
                             _resolve_signature(sig_b)))
        except (DecodeError, ValueError):
            continue
    if not prepared:
        return results
    hashes = hash_to_g2_batch([p[2] for p in prepared])
    jobs = [[(agg, h), (neg_g1, sig)]
            for (_, agg, _, sig), h in zip(prepared, hashes)]
    METRICS.observe("miller_loops_per_batch", 2 * len(jobs))
    for (i, *_), v in zip(prepared, _run_pairing_checks(jobs)):
        results[i] = bool(v)
    return results


def aggregate_verify_batch(pubkey_lists, message_lists, signatures):
    """Batch of AggregateVerify jobs (distinct message a pubkey): one flat
    hash batch across all jobs, then the exact per-job check."""
    prepared = []   # (slot, pk_points, msgs, sig)
    results = [False] * len(pubkey_lists)
    neg_g1 = -cv.g1_generator()
    for i, (pks, msgs, sig_b) in enumerate(
            zip(pubkey_lists, message_lists, signatures)):
        if not len(pks) or len(pks) != len(msgs):
            continue
        try:
            pk_points = [_resolve_pubkey(pk_b) for pk_b in pks]
            prepared.append((i, pk_points, [bytes(m) for m in msgs],
                             _resolve_signature(sig_b)))
        except (DecodeError, ValueError):
            continue
    if not prepared:
        return results
    flat_hashes = hash_to_g2_batch(
        [m for (_, _, msgs, _) in prepared for m in msgs])
    jobs = []
    pos = 0
    for (_, pk_points, msgs, sig) in prepared:
        hs = flat_hashes[pos:pos + len(msgs)]
        pos += len(msgs)
        jobs.append(list(zip(pk_points, hs)) + [(neg_g1, sig)])
    METRICS.observe("miller_loops_per_batch", sum(len(j) for j in jobs))
    for (i, *_), v in zip(prepared, _run_pairing_checks(jobs)):
        results[i] = bool(v)
    return results


def pairing_check_points(pairs):
    """Single pairing-check over oracle Point pairs."""
    live = [(p, q) for p, q in pairs
            if not (p.is_infinity() or q.is_infinity())]
    if not live:
        return True
    return bool(_run_pairing_checks([live])[0])


# single-job conveniences (the utils.bls shim routes through these)
def Verify(pubkey, message, signature) -> bool:
    return verify_batch([pubkey], [message], [signature])[0]


def FastAggregateVerify(pubkeys, message, signature) -> bool:
    return fast_aggregate_verify_batch([pubkeys], [message], [signature])[0]


def AggregateVerify(pubkeys, messages, signature) -> bool:
    return aggregate_verify_batch([pubkeys], [messages], [signature])[0]
