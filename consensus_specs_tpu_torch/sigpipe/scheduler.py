"""Scheduling: many signature sets -> fewest verification dispatches.

Counterpart of consensus_specs_tpu/sigpipe/scheduler.py.  Two strategies,
both returning one verdict per set:

* ``fused`` (default): every required set contributes to ONE combined
  pairing-product check, e(c_i agg_pk_i, H(root_i)) e(-c_i g1, sig_i) over
  all sets == 1.  The c_i are 64-bit Fiat-Shamir coefficients derived from
  a length-framed digest of the batch content: without them a block
  carrying two individually invalid signatures whose errors cancel would
  pass the product check; with them cancellation requires predicting
  coefficients that depend on the very signatures chosen (about 2^-64
  residual risk, the design of production clients' batch verification).
  On a False product, bisection (bisect.py) re-checks halves to isolate
  the offending sets.  Valid-or-skip sets (``required=False``: deposit
  proofs of possession, which the spec skips rather than rejects) ride a
  separate per-set dispatch, so an invalid deposit never bisects the
  product.
* ``per-set``: homogeneous grouping through the shim's batch entry
  points (single-pubkey sets through one `VerifyBatch`, aggregate sets
  through one `FastAggregateVerifyBatch`).

Degenerate sets never reach a dispatch: empty pubkey lists and
undecodable points read as invalid at once, exactly the scalar API's
False-on-DecodeError contract.

The flush's device steps: all cold committee sums ride one segment-sum
call (cache.aggregate_many -> ops/g1_sweep.py), and with folding on
(fold.py, the default) the N signature legs fold into one e(-g1, S) pair,
so an N-set flush pays N + 1 Miller loops instead of 2N.  On the device
backend with the fused pairing mode the whole folded flush is the
one-launch fold (fold.fold_flush: cofactor ladder, weighting, G2 sum and
partial Miller product on the card, then one final exponentiation);
otherwise the staged chain runs: hash-to-G2 of the roots, one weighting
sweep (ops/msm.g1_weighted_sweep, N points folded or 2N unfolded), the
G2 fold (fold.fold_signatures) and one `bls.pairing_check`.  Bisection
probes re-derive both legs of each set on the host ladder, so a corrupt
device sweep or fold can only fail the product, never flip a per-set
verdict.

What the port leaves out: the resilience dispatch and its host fallbacks
around each device call (a device failure raises), the async engine's
overlapped hash leg (this is the reference's ``ASYNC_FLUSH=0`` path), the
sharded product and the differential guard, which the reference installs
only in tests.
"""
from __future__ import annotations

import hashlib

from ..crypto import curve as cv
from ..crypto.bls12_381 import _load_signature
from ..crypto.curve import DecodeError
from ..utils import bls
from . import bisect as _bisect
from . import fold
from .cache import AGGREGATES
from .metrics import METRICS


def _hash_roots(roots):
    """hash-to-G2 of every signing root: one device cofactor ladder on the
    device backend (ops/bls_cuda.hash_to_g2_batch), host math on native."""
    if bls.current_backend() == "cuda":
        from ..ops.bls_cuda import hash_to_g2_batch
        return hash_to_g2_batch(roots)
    from ..crypto.hash_to_curve import hash_to_g2
    return [hash_to_g2(r) for r in roots]


def _coefficients(entries):
    """64-bit nonzero Fiat-Shamir coefficients, one per entry, bound to a
    length-framed digest of the whole batch (set count, per-set pubkey
    count and field lengths are all hashed, so no two distinct batch
    layouts share a transcript)."""
    h = hashlib.sha256()
    h.update(len(entries).to_bytes(4, "little"))
    for s, _agg, _sig in entries:
        h.update(len(s.pubkeys).to_bytes(4, "little"))
        for pk in s.pubkeys:
            h.update(pk)
        h.update(len(s.signing_root).to_bytes(4, "little"))
        h.update(s.signing_root)
        h.update(s.signature)
    seed = h.digest()
    out = []
    for i in range(len(entries)):
        x = int.from_bytes(
            hashlib.sha256(seed + i.to_bytes(4, "little")).digest()[:8],
            "little")
        out.append(1 + x % (2**64 - 1))
    return out


def _prepare(indices, sets, verdicts):
    """Decode each set's signature and batch-aggregate every G1 side
    through the aggregate cache (all cold committee sums of the flush in
    one segment-sum call).  Fills `verdicts` with False for sets the
    scalar API would reject before pairing."""
    pending = []
    for i in indices:
        s = sets[i]
        if len(s.pubkeys) == 0:
            verdicts[i] = False      # scalar FastAggregateVerify: False
            continue
        try:
            sig = _load_signature(s.signature)
        except (DecodeError, ValueError):
            verdicts[i] = False
            continue
        pending.append((i, s, sig))
    aggs = AGGREGATES.aggregate_many(
        [(s.pubkeys, s.hint) for _i, s, _sig in pending])
    prepared = []
    for (i, _s, sig), agg in zip(pending, aggs):
        if agg is None:              # a pubkey failed decode/validation
            verdicts[i] = False
            continue
        prepared.append((i, agg, sig))
    return prepared


def _host_scalar_mul(point, k):
    """Host double-and-add ladder with its point-op cost counted (the
    bisection probes' weighting)."""
    k = int(k)
    METRICS.inc("host_point_adds",
                max(k.bit_length(), 1) + bin(k).count("1"))
    return point * k


def _pairing_product(pairs):
    """The fused product's one check: `bls.pairing_check`, the pairing
    kernels on the device backend."""
    return bls.pairing_check(pairs)


def _weighted_g1(points, coeffs):
    """All Fiat-Shamir weightings of a staged flush as one sweep
    (ops/msm.g1_weighted_sweep, the G1 ladder kernel on the card)."""
    from ..ops import msm as _msm
    METRICS.inc("msm_dispatches")
    return _msm.g1_weighted_sweep(points, coeffs)


def _verify_fused(sets, prepared, verdicts):
    """One combined product over the prepared sets, bisected on failure.
    With folding live the flush emits N + 1 pairing legs (N weighted
    aggregate legs and one e(-g1, S) leg over the folded G2 sum) instead
    of 2N; on the one-launch path the whole chain is `fold.fold_flush`.
    `FOLD_VERIFY=0` restores the 2N-leg assembly."""
    entries = [(sets[i], agg, sig) for i, agg, sig in prepared]
    folded = fold.live()
    one_launch = folded and fold.one_launch_live()
    roots = [s.signing_root for s, _, _ in entries]
    hashes = None
    if not one_launch:
        hashes = _hash_roots(roots)
    coeffs = _coefficients(entries)
    neg_g1 = -cv.g1_generator()
    METRICS.inc_labeled("fold_enabled", "on" if folded else "off")
    if one_launch:
        METRICS.inc("dispatches")
        ok = fold.fold_flush(
            [agg for _s, agg, _sig in entries], coeffs, roots,
            [sig for _s, _agg, sig in entries])
    else:
        if folded:
            # N weightings instead of 2N: the signature legs' coefficients
            # ride the G2 fold
            bases = [agg for _s, agg, _sig in entries]
            scalars = list(coeffs)
        else:
            bases, scalars = [], []
            for (_s, agg, _sig), c in zip(entries, coeffs):
                bases.extend((agg, neg_g1))
                scalars.extend((c, c))
        weighted_flat = _weighted_g1(bases, scalars)
        if folded:
            S = fold.fold_signatures(
                [sig for _s, _agg, sig in entries], coeffs)
            pairs = [(weighted_flat[k], h) for k, h in enumerate(hashes)]
            pairs.append((neg_g1, S))
        else:
            pairs = []
            for k, ((_s, _agg, sig), h) in enumerate(zip(entries, hashes)):
                pairs.append((weighted_flat[2 * k], h))
                pairs.append((weighted_flat[2 * k + 1], sig))
        METRICS.observe("miller_loops_per_flush", len(pairs))
        METRICS.inc("dispatches")
        ok = _pairing_product(pairs)

    def group_valid(sub_groups):
        # bisection probe: re-derive each group's weighted pairs on the
        # host ladder, both legs a set (the folded product cannot
        # attribute), so isolation never trusts the device's weighting
        METRICS.inc("dispatches")
        probe_pairs = []
        for agg, c, h, sig in sub_groups:
            probe_pairs.append((_host_scalar_mul(agg, c), h))
            probe_pairs.append((_host_scalar_mul(neg_g1, c), sig))
        return bls.pairing_check(probe_pairs)

    if ok:
        bad_local = set()
    else:
        METRICS.inc("fused_batch_failures")
        if hashes is None:
            # one-launch failure: the per-set hashes never left the card;
            # derive them now for the probes
            hashes = _hash_roots(roots)
        groups = [(agg, c, h, sig) for (_s, agg, sig), h, c in zip(
            entries, hashes, coeffs)]
        if len(groups) == 1:
            # a one-set flush re-checks on the host ladder: the failing
            # product used device-weighted points
            bad_local = set() if group_valid(groups) else {0}
        else:
            bad_local = set(_bisect.isolate_failures(groups, group_valid))
    for rank, (i, _agg, _sig) in enumerate(prepared):
        verdicts[i] = rank not in bad_local


def _verify_per_set(indices, sets, verdicts):
    """Per-set verdicts through the shim's batch APIs (which screen empty
    lists and decode failures themselves)."""
    singles = [i for i in indices if len(sets[i].pubkeys) == 1]
    multis = [i for i in indices if len(sets[i].pubkeys) != 1]
    if singles:
        METRICS.inc("dispatches")
        for i, v in zip(singles, bls.VerifyBatch(
                [sets[i].pubkeys[0] for i in singles],
                [sets[i].signing_root for i in singles],
                [sets[i].signature for i in singles])):
            verdicts[i] = bool(v)
    if multis:
        # every job's committee sum rides the one batched aggregation, and
        # the batch API receives the pre-aggregated point.  Jobs whose
        # pubkeys fail decode keep their original list (the batch API's
        # own screening reads them as invalid), and so does the identity
        # aggregate: compressed-infinity pubkeys are rejected at decode,
        # which a substitution would wrongly skip
        aggs = AGGREGATES.aggregate_many(
            [(sets[i].pubkeys, sets[i].hint) for i in multis])
        pk_lists = [
            [agg] if agg is not None and not agg.is_infinity()
            else list(sets[i].pubkeys)
            for i, agg in zip(multis, aggs)]
        METRICS.inc("dispatches")
        for i, v in zip(multis, bls.FastAggregateVerifyBatch(
                pk_lists,
                [sets[i].signing_root for i in multis],
                [sets[i].signature for i in multis])):
            verdicts[i] = bool(v)


def verify_sets(sets, mode: str = "fused"):
    """Verdict per SignatureSet.  `mode` is "fused" or "per-set"."""
    n = len(sets)
    if n == 0:
        return []       # an empty window is not a batch
    METRICS.observe("batch_size", n)
    METRICS.observe_hist("batch_occupancy", n)
    METRICS.inc("signatures_scheduled", n)
    if not bls.bls_active:
        # stub-True contract, zero dispatches (matches the scalar API)
        METRICS.inc("stubbed_batches")
        return [True] * n
    verdicts: list = [None] * n
    with METRICS.timer("verify_sets"):
        if mode == "per-set":
            _verify_per_set(list(range(n)), sets, verdicts)
        elif mode == "fused":
            strict = [i for i, s in enumerate(sets) if s.required]
            lax = [i for i, s in enumerate(sets) if not s.required]
            prepared = _prepare(strict, sets, verdicts)
            if prepared:
                _verify_fused(sets, prepared, verdicts)
            if lax:
                _verify_per_set(lax, sets, verdicts)
        else:
            raise ValueError(f"unknown sigpipe mode {mode!r}")
    return verdicts
