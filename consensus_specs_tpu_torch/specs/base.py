"""Spec-object machinery.

Counterpart of consensus_specs_tpu/specs/base.py without the signature
verification seams, which come with the BLS slice.  Each fork is a class; a
*spec instance* is (fork class × preset × config), carrying its own SSZ
container classes (preset values define vector/list shapes) and all spec
functions as methods.  Class inheritance gives the consensus-specs fork-overlay
semantics (pysetup/helpers.py combine_spec_objects — later fork wins).
"""
from __future__ import annotations

from ..config import Config, load_config, load_preset


class BaseSpec:
    fork: str = "base"

    def __init__(self, preset_name: str = "mainnet",
                 config: Config | None = None):
        self.preset_name = preset_name
        self.preset = load_preset(preset_name)
        self.config = config if config is not None else load_config(preset_name)
        # preset values become plain attributes (compile-time tier)
        for k, v in self.preset.items():
            setattr(self, k, v)
        self._build_constants()
        self._build_types()

    def _build_constants(self) -> None:
        pass

    def _build_types(self) -> None:
        pass

    def is_post(self, fork_name: str) -> bool:
        """True if this spec builds on the given fork (MRO ancestry)."""
        mro_forks = [c.fork for c in type(self).__mro__
                     if hasattr(c, "fork")]
        return fork_name in mro_forks
