"""Bare-model weights from disk.

Counterpart of the `.bin` branch of `maskbit_tpu/core/checkpoint.load_pretrained`:
a PyTorch state dict in the original repo's layout, with its legacy
`token_emb.` -> `input_proj.` rename for LFQBert. The `.msgpack` format of
the JAX package is not read yet.
"""

from __future__ import annotations

from typing import Dict

import torch


def load_pretrained(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Load a `.bin` / `.pth` / `.pt` state dict onto `device`."""
    if not path.endswith((".bin", ".pth", ".pt")):
        raise NotImplementedError(f"{path}: only PyTorch state dicts load in the port")
    state = torch.load(path, map_location=device, weights_only=True)
    if "state_dict" in state and isinstance(state["state_dict"], dict):
        state = state["state_dict"]
    return {("input_proj." + k[len("token_emb."):] if k.startswith("token_emb.") else k): v
            for k, v in state.items()}
