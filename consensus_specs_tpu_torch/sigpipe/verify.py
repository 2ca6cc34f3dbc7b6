"""Pipeline driver: collect a block's signature sets, verify them in one
batch, and let the spec consume the verdicts at its own call sites.

Counterpart of consensus_specs_tpu/sigpipe/verify.py.  Opt-in:

    from consensus_specs_tpu_torch import sigpipe
    sigpipe.enable()            # or sigpipe.enable(mode="per-set")
    spec.state_transition(state, signed_block)
    sigpipe.disable()

`state_transition` wraps block processing in `block_scope`, which
precomputes a verdict for every signature check the block implies
(sets.collect_block_sets -> scheduler.verify_sets) and installs the map on
the spec instance.  The verification seams (`BaseSpec.bls_verify` /
`bls_fast_aggregate_verify`) look verdicts up by content (pubkeys,
signing_root, signature), so a batch verdict stands in for the scalar call
at exactly the inline call site: an invalid block raises the same
AssertionError at the same operation, with the same partial state
mutations, as the scalar path.  A check the collector did not predict
misses the map and the seam verifies it alone (counted in `seam_misses`).

Unlike the reference, a failure inside the pipeline raises: `block_scope`
has no `except` that would rerun the block on the scalar path.  The async
flush engine (`pipeline_async`, `LazyVerdictMap`) and the electra
`pending_deposit_scope` are not ported yet, nor the gossip window's
outer verdict map that the reference lifts verdicts from; this is the
reference's synchronous branch (`ASYNC_FLUSH=0`).
"""
from __future__ import annotations

from contextlib import contextmanager

from . import scheduler, sets
from .metrics import METRICS

_enabled = False
_mode = "fused"


def enable(mode: str = "fused") -> None:
    """Route state_transition signature checks through the batch pipeline.
    `mode`: "fused" (one combined pairing check + bisection) or "per-set"
    (VerifyBatch/FastAggregateVerifyBatch grouping)."""
    global _enabled, _mode
    if mode not in ("fused", "per-set"):
        raise ValueError(f"unknown sigpipe mode {mode!r}")
    _enabled = True
    _mode = mode


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def mode() -> str:
    return _mode


class VerdictMap:
    """Content-addressed verdicts: (pubkeys, signing_root, signature) ->
    bool.  The spec seams consult it; a miss verifies alone."""

    def __init__(self, verdicts: dict):
        self._verdicts = verdicts

    def lookup(self, pubkeys, signing_root, signature):
        v = self._verdicts.get((pubkeys, signing_root, signature))
        if v is None:
            METRICS.inc("seam_misses")
            METRICS.inc_labeled("scalar_fallbacks", "collector_miss")
        else:
            METRICS.inc("seam_hits")
        return v


def _batch_verify_unique(collected):
    """Dedup identical checks (same pubkeys/root/signature verify once),
    batch-verify them in the enabled mode, and return the content-keyed
    verdict dict."""
    unique: dict = {}
    for s in collected:
        unique.setdefault(s.key(), s)
    dropped = len(collected) - len(unique)
    if dropped:
        METRICS.inc("dedup_saved", dropped)
    unique_sets = list(unique.values())
    unique_verdicts = scheduler.verify_sets(unique_sets, mode=_mode)
    return {s.key(): v for s, v in zip(unique_sets, unique_verdicts)}


def compute_verdicts(spec, state, signed_block):
    """Collect and batch-verify every signature check in `signed_block`;
    returns (VerdictMap, collected sets, per-set verdict list)."""
    block_sets = sets.collect_block_sets(spec, state, signed_block)
    by_key = _batch_verify_unique(block_sets)
    return (VerdictMap(by_key), block_sets,
            [by_key[s.key()] for s in block_sets])


def verify_block_signatures(spec, state, signed_block) -> None:
    """Eager API: batch-verify every signature check the block implies;
    None if they all pass, AssertionError naming the first failing
    operation otherwise (deposit sets are valid-or-skip and never raise).
    `state` must be advanced to the block's slot."""
    _vm, block_sets, verdicts = compute_verdicts(spec, state, signed_block)
    for s, ok in zip(block_sets, verdicts):
        assert ok or not s.required, \
            f"sigpipe: invalid {s.kind} signature at {s.origin or s.kind}"


@contextmanager
def block_scope(spec, state, signed_block):
    """Install batch verdicts on `spec` for the duration of one block's
    processing (a no-op while the pipeline is disabled).  `state` must be
    advanced to the block's slot; a pipeline failure raises."""
    if not _enabled:
        yield
        return
    vm, _sets, _verdicts = compute_verdicts(spec, state, signed_block)
    with spec.install_sigpipe_verdicts(vm):
        yield
