"""Two-tier parameter system.

*Presets* (compile-time; define SSZ shapes, trigger type rebuilds) and
*configs* (runtime; swappable per test via with_config_overrides) — the same
split as consensus-specs (setup.py bake-in vs
eth2spec/config/config_util.py runtime loader; SURVEY.md §5).  A copy of
consensus_specs_tpu/config/__init__.py.
"""
from __future__ import annotations

from .params import PRESETS, CONFIGS


class Config:
    """Attribute-access view over a config dict (runtime tier)."""

    def __init__(self, values: dict):
        object.__setattr__(self, "_values", dict(values))

    def __getattr__(self, name):
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        raise AttributeError("Config is immutable; use replace()")

    def get(self, name, default=None):
        return self._values.get(name, default)

    def replace(self, **overrides) -> "Config":
        merged = dict(self._values)
        merged.update(overrides)
        return Config(merged)

    def as_dict(self) -> dict:
        return dict(self._values)


def load_preset(preset_name: str) -> dict:
    """Merged preset values across all forks (keys are globally unique)."""
    if preset_name not in PRESETS:
        raise KeyError(f"unknown preset {preset_name!r}")
    merged = {}
    for fork_vals in PRESETS[preset_name].values():
        merged.update(fork_vals)
    return merged


def load_config(config_name: str, overrides: dict | None = None) -> Config:
    if config_name not in CONFIGS:
        raise KeyError(f"unknown config {config_name!r}")
    values = dict(CONFIGS[config_name])
    if overrides:
        values.update(overrides)
    return Config(values)
