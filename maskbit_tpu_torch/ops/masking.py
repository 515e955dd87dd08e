"""Masking schedule for iterative sampling.

Counterpart of `maskbit_tpu/ops/masking.get_masking_ratio`: progress ∈ (0, 1]
-> fraction of tokens still masked, clipped to [1e-6, 1], in float32.
"""

from __future__ import annotations

import math

import torch

_PI_HALF = math.pi * 0.5

INFERENCE_MODES = ("root", "square", "cosine", "arccos", "linear")


def get_masking_ratio(progress, mode: str = "arccos") -> torch.Tensor:
    """Masking ratio at a given sampling progress ∈ (0, 1]."""
    r = torch.as_tensor(progress, dtype=torch.float32)
    if mode == "root":
        val = 1.0 - torch.sqrt(r)
    elif mode == "square":
        val = 1.0 - r**2
    elif mode == "cosine":
        val = torch.cos(r * _PI_HALF)
    elif mode == "arccos":
        val = torch.arccos(r) / _PI_HALF
    elif mode == "linear":
        val = 1.0 - r
    else:
        raise ValueError(f"Invalid mode {mode!r}. Choose from {INFERENCE_MODES}.")
    return torch.clamp(val, 1e-6, 1.0)
