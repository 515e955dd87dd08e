"""Masking schedules for masked-token training and iterative sampling.

Counterpart of `maskbit_tpu/ops/masking.py`:
  * `get_mask_tokens`: training-time random masking, with the per-image
    ratio drawn through `mask_ratio_from_uniform`;
  * `get_masking_ratio`: sampling progress ∈ (0, 1] -> fraction of tokens
    still masked, clipped to [1e-6, 1], in float32.
Random draws come from an explicit `torch.Generator`; `injected=` takes the
draws instead (tests hand both frameworks the same numbers).
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch

_PI_HALF = math.pi * 0.5

TRAIN_MODES = ("linear", "square", "cosine", "arccos")
INFERENCE_MODES = ("root", "square", "cosine", "arccos", "linear")


def mask_ratio_from_uniform(r: torch.Tensor, mode: str) -> torch.Tensor:
    """Transform uniform draws r ∈ [0, 1) into a masking fraction (training)."""
    if mode == "linear":
        return 1.0 - r
    if mode == "square":
        return 1.0 - r**2
    if mode == "cosine":
        return torch.cos(r * _PI_HALF)
    if mode == "arccos":
        return torch.arccos(r) / _PI_HALF
    raise ValueError(f"Invalid mode {mode!r}. Choose from {TRAIN_MODES}.")


def get_mask_tokens(tokens: torch.Tensor, mask_token: int, mode: str = "arccos",
                    min_masking_ratio: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    injected: Optional[Mapping[str, torch.Tensor]] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Randomly mask tokens (b, ...) for MLM training.

    The per-image uniform `r` (b,) and the per-token uniform (tokens.shape)
    come from `generator`, or from `injected["mask_ratio_uniform"]` and
    `injected["mask_token_uniform"]`. Returns (masked_tokens, mask), mask
    True at masked positions."""
    b, dev = tokens.shape[0], tokens.device
    if injected is not None:
        r = torch.as_tensor(injected["mask_ratio_uniform"], dtype=torch.float32, device=dev)
        u = torch.as_tensor(injected["mask_token_uniform"], dtype=torch.float32, device=dev)
    elif generator is not None:
        r = torch.rand((b,), generator=generator, device=dev)
        u = torch.rand(tokens.shape, generator=generator, device=dev)
    else:
        raise ValueError("get_mask_tokens needs a torch.Generator or injected draws")
    val_to_mask = mask_ratio_from_uniform(r * (1.0 - min_masking_ratio), mode)
    mask = u < val_to_mask.reshape((b,) + (1,) * (tokens.dim() - 1))
    masked = torch.where(mask, torch.as_tensor(mask_token, dtype=tokens.dtype, device=dev), tokens)
    return masked, mask


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
