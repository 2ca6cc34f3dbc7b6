"""PyTorch port of consensus_specs_tpu for NVIDIA Hopper cards.

The JAX package `consensus_specs_tpu` is the reference; this package holds the
slices ported so far, with module paths and names kept so each counterpart can
be found.  Its hot path runs on a CUDA card by default: call `set_device("cpu")`
to run the plain torch versions on the host instead.
"""
import torch

_device = torch.device("cuda")


def set_device(device) -> None:
    """Choose where the port hashes: "cuda" (the default) or "cpu"."""
    global _device
    _device = torch.device(device)


def get_device() -> torch.device:
    return _device
