"""Pipeline metrics: counters and power-of-two histograms.

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

The reference routes every call through a per-node context and a named
lock registry; the port keeps one registry behind one plain lock.
"""
from __future__ import annotations

import threading


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.counters: dict = {}
            self.histograms: dict = {}

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + by

    def count(self, name: str) -> int:
        with self._lock:
            return self.counters.get(name, 0)

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

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            for name, series in self.histograms.items():
                out[f"{name}_hist"] = {
                    b: series[b] for b in sorted(series, key=int)}
            return out


METRICS = Metrics()
