"""Bisection fallback: isolate failing sets inside a failed batch.

The fused scheduler path verifies a whole group of signature sets with a
single combined pairing check — one device dispatch, one boolean.  When
that boolean is False, the caller still needs *which* sets failed, because
the spec raises at the failing operation's own call site (byte-identical
invalid-block behavior).  `isolate_failures` recursively halves the group,
re-dispatching each half, until the offending singletons are found:
log-many extra dispatches for the (rare) invalid block instead of falling
all the way back to one dispatch per signature.
"""
from __future__ import annotations

from .metrics import METRICS


def isolate_failures(items, group_valid, metrics=METRICS):
    """Indices of invalid items within `items`.

    `group_valid(sub_items) -> bool` must return True iff every item in
    the sub-list verifies (the scheduler's combined pairing check).  The
    caller has already observed `group_valid(items)` == False; this
    function only splits, so a group of one failing item costs no extra
    dispatch.
    """
    bad: list = []
    _split(list(items), 0, group_valid, bad, 1, metrics)
    return bad


def _split(items, base, group_valid, bad, depth, metrics):
    if metrics is not None:
        metrics.observe("bisect_depth", depth)
    if len(items) == 1:
        bad.append(base)
        return
    mid = len(items) // 2
    for lo, sub in ((0, items[:mid]), (mid, items[mid:])):
        if metrics is not None:
            metrics.inc("bisect_dispatches")
        if not group_valid(sub):
            _split(sub, base + lo, group_valid, bad, depth + 1, metrics)
