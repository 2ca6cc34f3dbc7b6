"""Pipeline metrics: counters, labeled counters, observations, power-of-two
histograms and wall-clock timers.

A slim copy of consensus_specs_tpu/sigpipe/metrics.py: one module-global
`METRICS` registry with the calls incremental merkleization
(ssz/incremental.py) makes, under the same counter names, so one
`snapshot()` describes a run's sweeps:

- `merkle_sweep_dispatches`: one per re-rooted tracked view;
- `merkle_sweep_levels`: hash rounds inside those sweeps, bounded by the
  state tree's height;
- `merkle_chunks_hashed`: 2-to-1 hashes the sweeps performed, O(diff ·
  log state);
- `merkle_dirty_nodes`: dirty leaf chunks swept, with the power-of-two
  `merkle_dirty_occupancy` histogram;
- `merkle_device_round_trips`: host<->device round trips, one per fused
  sweep, and its siblings
  `merkle_sibling_uploads` (literal chunks a fused sweep uploaded) and
  `merkle_sibling_uploads_skipped` (literals found already in the device
  pool);
- `merkle_cache_builds`, `merkle_cached_roots`, `merkle_guard_samples` and
  `merkle_guard_mismatches`;

and the calls of the fused epoch engine (specs/epoch_fast.py):

- `epoch_sweep_dispatches`: one per fused `process_epoch` (one
  `ops.epoch_sweep.run_sweep`: one upload, one launch sequence, one
  download);
- `epoch_writeback_elems`: balances and effective balances the epoch wrote
  back;
- `epoch_guard_samples` and `epoch_guard_mismatches`: epochs whose lanes
  the differential guard recomputed with the plain version on the host,
  and those that disagreed (a mismatch also raises).

and the observation of the BLS path (ops/bls_cuda.py):

- `miller_loops_per_batch`: the pairs of each batched pairing check that
  a FastAggregateVerify or AggregateVerify batch dispatched (count,
  total, min, max and mean), one observation a batch;

and the calls of the signature pipeline (sigpipe/), under the reference's
names:

- `signatures_scheduled`, the observation `batch_size` and the histogram
  `batch_occupancy`: the sets each `verify_sets` call took;
- `dispatches`: verification dispatches (a flush's product, a bisection
  probe, a per-set batch); `fold_dispatches`: folded flushes, staged
  G2 folds and KZG batch lincombs; `msm_dispatches`: Fiat-Shamir
  weighting sweeps;
- `kzg_pairing_legs`: the pairing legs of each KZG blob batch verify
  (2 batched, 2N blob by blob) and `kzg_batch_attributions`: failed
  batches re-checked blob by blob (crypto/kzg.py);
- `miller_loops_per_flush`: the pairing legs of each fused flush, N + 1
  folded against 2N unfolded; the labeled `fold_enabled` (`on`, `off`);
- `fused_batch_failures`, `bisect_dispatches` and the observation
  `bisect_depth`: failed products and their isolation;
- `host_point_adds`: point operations of the host ladder that bisection
  probes re-derive their weighted pairs with;
- `seam_hits`, `seam_misses` (with the labeled `scalar_fallbacks`,
  `collector_miss`) and `dedup_saved`: how the block's checks met the
  verdict map;
- `pubkey_cache_*`, `aggregate_cache_*` and `g1_aggregate_dispatches`:
  the pubkey caches and their batched committee sums;
- the timer `verify_sets` (the snapshot's `verify_sets_sec`).

The kernels' own counts are the wrappers' `.launches` and `.plain_calls`
(ops/sha256_cuda.py, ops/epoch_sweep_cuda.py, ops/bls381_cuda.py), not
counters here.

The reference routes every call through a per-node context and a named
lock registry; the port keeps one registry behind one plain lock.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.counters: dict = {}
            self.labeled: dict = {}
            self.observations: dict = {}
            self.histograms: dict = {}
            self.timers: dict = {}

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + by

    def count(self, name: str) -> int:
        with self._lock:
            return self.counters.get(name, 0)

    def inc_labeled(self, name: str, label: str, by: int = 1) -> None:
        """One counter per (name, label) pair."""
        with self._lock:
            series = self.labeled.setdefault(name, {})
            series[label] = series.get(label, 0) + by

    def observe(self, name: str, value) -> None:
        """Fold one observation into `name`'s count, total, min and max
        (no per-sample storage)."""
        with self._lock:
            o = self.observations.get(name)
            if o is None:
                self.observations[name] = {"count": 1, "total": value,
                                           "min": value, "max": value}
            else:
                o["count"] += 1
                o["total"] += value
                o["min"] = min(o["min"], value)
                o["max"] = max(o["max"], value)

    @staticmethod
    def _bucket(value: int) -> str:
        if value <= 0:
            return "0"
        return str(1 << (int(value) - 1).bit_length())

    def observe_hist(self, name: str, value: int) -> None:
        """Count `value` into its power-of-two bucket (1,2,4,8,...):
        bucket "8" holds observations in (4, 8]."""
        bucket = self._bucket(value)
        with self._lock:
            series = self.histograms.setdefault(name, {})
            series[bucket] = series.get(bucket, 0) + 1

    def hist_counts(self, name: str) -> dict:
        with self._lock:
            return dict(self.histograms.get(name, {}))

    @contextmanager
    def timer(self, name: str):
        """Add the wall seconds of the block to the timer `name`."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - t0
            with self._lock:
                self.timers[name] = self.timers.get(name, 0.0) + elapsed

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            for name, series in self.labeled.items():
                out[name] = dict(series)
            for name, o in self.observations.items():
                out[name] = dict(o, mean=o["total"] / o["count"])
            for name, series in self.histograms.items():
                out[f"{name}_hist"] = {
                    b: series[b] for b in sorted(series, key=int)}
            for name, secs in self.timers.items():
                out[f"{name}_sec"] = round(secs, 6)
            return out


METRICS = Metrics()
