"""Counterpart of consensus_specs_tpu/sigpipe: only its metrics registry is
ported so far (what ssz/incremental.py reports into)."""
from .metrics import METRICS  # noqa: F401
