"""Block-level deferred signature verification pipeline.

Counterpart of consensus_specs_tpu/sigpipe: collect every signature check a
signed block implies (sets.py), verify them together in the fewest device
dispatches (scheduler.py, with the folded product of fold.py), isolate
failures by bisection (bisect.py), cache decompressed and aggregated
pubkeys (cache.py) and surface counters (metrics.py).  verify.py wires the
pipeline into `state_transition` behind the opt-in `enable()` switch; the
inline scalar path stays the default.  The async flush engine and electra's
pending-deposit scope are not ported yet.
"""
from .metrics import METRICS
from .sets import SignatureSet, collect_block_sets
from .verify import (
    block_scope, compute_verdicts, disable, enable, enabled, mode,
    verify_block_signatures,
)

__all__ = [
    "METRICS", "SignatureSet", "collect_block_sets", "block_scope",
    "compute_verdicts", "disable", "enable", "enabled", "mode",
    "verify_block_signatures",
]
