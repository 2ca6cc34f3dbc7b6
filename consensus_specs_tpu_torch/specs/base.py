"""Spec-object machinery.

Counterpart of consensus_specs_tpu/specs/base.py, with its signature
verification seams (`bls_verify`, `bls_fast_aggregate_verify`), through
which every signature check of the spec reaches utils/bls.py, or the
verdict map the signature pipeline installs (sigpipe/verify.py
`block_scope`).  Each fork is a class; a
*spec instance* is (fork class × preset × config), carrying its own SSZ
container classes (preset values define vector/list shapes) and all spec
functions as methods.  Class inheritance gives the consensus-specs fork-overlay
semantics (pysetup/helpers.py combine_spec_objects — later fork wins).
"""
from __future__ import annotations

from contextlib import contextmanager

from ..config import Config, load_config, load_preset
from ..utils import bls


class BaseSpec:
    fork: str = "base"

    # verdict map of a signature-pipeline window (None: every seam call is
    # a plain scalar verify)
    _sigpipe_verdicts = None

    def __init__(self, preset_name: str = "mainnet",
                 config: Config | None = None):
        self.preset_name = preset_name
        self.preset = load_preset(preset_name)
        self.config = config if config is not None else load_config(preset_name)
        # preset values become plain attributes (compile-time tier)
        for k, v in self.preset.items():
            setattr(self, k, v)
        # memoized pure accessors of this spec instance (the shuffle LRU)
        self._caches: dict = {}
        self._build_constants()
        self._build_types()

    def _build_constants(self) -> None:
        pass

    def _build_types(self) -> None:
        pass

    def _cached(self, key, fn):
        """Memoize an expensive pure accessor on this spec instance."""
        cache = self._caches
        if key not in cache:
            cache[key] = fn()
        return cache[key]

    def is_post(self, fork_name: str) -> bool:
        """True if this spec builds on the given fork (MRO ancestry)."""
        mro_forks = [c.fork for c in type(self).__mro__
                     if hasattr(c, "fork")]
        return fork_name in mro_forks

    # -- signature verification seam -----------------------------------
    # Every per-operation signature check of the spec flows through these
    # two methods, so a precomputed batch verdict can stand in for the
    # scalar call at the exact call site.  A map miss falls back to the
    # scalar backend, so routing through the seam never changes behaviour.

    @contextmanager
    def install_sigpipe_verdicts(self, verdict_map):
        """Install a verdict map (an object with `lookup(pubkeys,
        signing_root, signature)` returning a bool or None) on this spec
        instance for the duration; nestable."""
        previous = self._sigpipe_verdicts
        self._sigpipe_verdicts = verdict_map
        try:
            yield
        finally:
            self._sigpipe_verdicts = previous

    def bls_verify(self, pubkey, signing_root, signature) -> bool:
        verdicts = self._sigpipe_verdicts
        if verdicts is not None:
            v = verdicts.lookup((bytes(pubkey),), bytes(signing_root),
                                bytes(signature))
            if v is not None:
                return v
        return bls.Verify(pubkey, signing_root, signature)

    def bls_fast_aggregate_verify(self, pubkeys, signing_root,
                                  signature) -> bool:
        verdicts = self._sigpipe_verdicts
        if verdicts is not None:
            v = verdicts.lookup(tuple(bytes(pk) for pk in pubkeys),
                                bytes(signing_root), bytes(signature))
            if v is not None:
                return v
        return bls.FastAggregateVerify(pubkeys, signing_root, signature)
