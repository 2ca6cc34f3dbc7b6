"""Spec registry: one cached spec instance per (fork, preset, config).

Counterpart of consensus_specs_tpu/specs/__init__.py, with the forks ported
so far (phase0, altair).
"""
from __future__ import annotations

from .altair import AltairSpec
from .phase0 import Phase0Spec

_REGISTRY: dict = {"phase0": Phase0Spec, "altair": AltairSpec}
_INSTANCES: dict = {}


def get_spec(fork_name: str, preset_name: str = "mainnet", config=None):
    """Spec instance for (fork, preset); instances with default config are
    cached, custom configs build fresh."""
    if fork_name not in _REGISTRY:
        raise KeyError(f"unknown fork {fork_name!r}; have {list(_REGISTRY)}")
    if config is not None:
        return _REGISTRY[fork_name](preset_name, config)
    key = (fork_name, preset_name)
    if key not in _INSTANCES:
        _INSTANCES[key] = _REGISTRY[fork_name](preset_name)
    return _INSTANCES[key]
