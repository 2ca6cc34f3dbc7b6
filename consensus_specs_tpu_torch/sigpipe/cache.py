"""Pubkey caches for the signature pipeline.

Counterpart of consensus_specs_tpu/sigpipe/cache.py.  Two layers, both
bounded (FIFO eviction):

* `PubkeyCache`: compressed 48-byte pubkey -> validated decompressed G1
  Point.  Decompression with the subgroup check is the per-key host cost
  of every verification; real clients cache it across blocks, so do we.
* `AggregatePubkeyCache`: participant-set digest -> aggregated G1 Point.
  The key is a content digest of the participant pubkeys, so a label
  collision can never return the wrong aggregate; entries carry a hint
  like ``("att", epoch, committee_index)`` for debugging.

Cold sums run on the device: `aggregate_many` fuses every cold set of a
call into one `ops/g1_sweep.g1_add_sweep` ragged-segment reduction (the
segment-sum kernel on the card), counted in `g1_aggregate_dispatches`.
Unlike the reference there is no resilience dispatch around it and no
per-set host loop to fall back to: a device failure raises.  Not
mirrored, for want of callers in the port: the insert tracking of txn/
rollbacks, the gossip prewarm (`warm_many`) and the async engine's write
barrier.

Hit and miss counters land in sigpipe.metrics.METRICS.  Each cache has one
lock around lookup, insert and evict; point decompression runs outside it.
"""
from __future__ import annotations

import hashlib
import threading

from ..crypto import curve as cv
from ..crypto.bls12_381 import _load_pubkey
from ..crypto.curve import DecodeError
from .metrics import METRICS


class PubkeyCache:
    def __init__(self, max_size: int = 1 << 16, metrics=METRICS):
        self._cache: dict = {}
        self._max = max_size
        self._metrics = metrics
        self._lock = threading.RLock()

    def get(self, pubkey) -> cv.Point:
        """Decompressed, validated G1 point for compressed bytes; raises
        DecodeError/ValueError exactly like the scalar `_load_pubkey`."""
        key = bytes(pubkey)
        with self._lock:
            point = self._cache.get(key)
        if point is not None:
            self._metrics.inc("pubkey_cache_hits")
            return point
        self._metrics.inc("pubkey_cache_misses")
        point = _load_pubkey(key)   # DecodeError / ValueError propagate
        with self._lock:
            if len(self._cache) >= self._max:
                self._cache.pop(next(iter(self._cache)))
            self._cache[key] = point
        return point

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()


class AggregatePubkeyCache:
    def __init__(self, pubkeys: PubkeyCache, max_size: int = 1 << 12,
                 metrics=METRICS):
        self._pubkeys = pubkeys
        self._cache: dict = {}
        self._max = max_size
        self._metrics = metrics
        self._lock = threading.RLock()

    @staticmethod
    def _digest(pubkey_bytes_list) -> bytes:
        return hashlib.sha256(
            b"".join(bytes(pk) for pk in pubkey_bytes_list)).digest()

    def _collect_cold(self, jobs):
        """Digest each (pubkey_bytes_list, hint) job, count cache hits and
        misses, decode the cold sets (a job whose pubkeys fail decode is
        dropped: the per-job stand-in for the scalar path's DecodeError or
        ValueError) and dedup by content digest within the call.  Returns
        (hits: job index -> cached Point,
         cold: digest -> (decompressed points, hint),
         slots: digest -> job indices awaiting that cold sum)."""
        hits: dict = {}
        cold: dict = {}
        slots: dict = {}
        for k, (pks, hint) in enumerate(jobs):
            digest = self._digest(pks)
            with self._lock:
                entry = self._cache.get(digest)
            if entry is not None:
                self._metrics.inc("aggregate_cache_hits")
                hits[k] = entry[0]
                continue
            if digest in cold:
                # an intra-call duplicate reads as a hit, matching the
                # sequential scalar path
                self._metrics.inc("aggregate_cache_hits")
                slots[digest].append(k)
                continue
            self._metrics.inc("aggregate_cache_misses")
            try:
                pts = [self._pubkeys.get(pk) for pk in pks]
            except (DecodeError, ValueError):
                continue
            cold[digest] = (pts, hint)
            slots[digest] = [k]
        return hits, cold, slots

    def aggregate_many(self, jobs) -> list:
        """Batch aggregation for a whole scheduler flush: `jobs` is a list
        of (pubkey_bytes_list, hint) pairs; returns one aggregated Point per
        job, or None where a pubkey failed decode or validation.  Hits come
        from the cache; all cold jobs' committee sums fuse into one
        `_sum_batch` device call, deduplicated by content digest."""
        hits, cold, slots = self._collect_cold(jobs)
        results = [None] * len(jobs)
        for k, agg in hits.items():
            results[k] = agg
        if cold:
            digests = list(cold)
            sums = self._sum_batch([cold[d][0] for d in digests])
            for digest, agg in zip(digests, sums):
                self._insert(digest, agg, cold[digest][1])
                for k in slots[digest]:
                    results[k] = agg
        return results

    def _sum_batch(self, point_lists) -> list:
        """The cold-sum path: one `g1_add_sweep` for every cold
        participant set of a call."""
        from ..ops.g1_sweep import g1_add_sweep
        self._metrics.inc("g1_aggregate_dispatches")
        return g1_add_sweep(point_lists)

    def _insert(self, digest, agg, hint) -> None:
        with self._lock:
            if len(self._cache) >= self._max:
                self._cache.pop(next(iter(self._cache)))
            self._cache[digest] = (agg, hint)

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()


# content-addressed: pubkey bytes -> decompressed Point, and participant-set
# digest -> aggregate, the same values whoever computes them
PUBKEYS = PubkeyCache()
AGGREGATES = AggregatePubkeyCache(PUBKEYS)


def clear() -> None:
    PUBKEYS.clear()
    AGGREGATES.clear()
