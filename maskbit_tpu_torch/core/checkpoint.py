"""Bare-model weights to and from disk.

`load_pretrained` is the counterpart of the `.bin` branch of
`maskbit_tpu/core/checkpoint.load_pretrained`: a PyTorch state dict in the
original repo's layout, with its legacy `token_emb.` -> `input_proj.` rename
for LFQBert. `save_pretrained` writes such a `.bin` (float32 tensors on the
CPU), which this loader and the JAX package's `load_pretrained` both read.
The `.msgpack` format of the JAX package is neither read nor written yet.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import torch
from torch import nn


def load_pretrained(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Load a `.bin` / `.pth` / `.pt` state dict onto `device`."""
    if not path.endswith((".bin", ".pth", ".pt")):
        raise NotImplementedError(f"{path}: only PyTorch state dicts load in the port")
    state = torch.load(path, map_location=device, weights_only=True)
    if "state_dict" in state and isinstance(state["state_dict"], dict):
        state = state["state_dict"]
    return {("input_proj." + k[len("token_emb."):] if k.startswith("token_emb.") else k): v
            for k, v in state.items()}


def save_pretrained(model: nn.Module, path: str,
                    params: Optional[Mapping[str, torch.Tensor]] = None) -> None:
    """Write `model`'s state dict as a `.bin`; `params` (name -> tensor, e.g.
    the EMA shadows) replace the model's parameters of the same names."""
    if not path.endswith(".bin"):
        raise NotImplementedError(f"{path}: the port writes `.bin` state dicts only")
    state = model.state_dict()
    if params is not None:
        missing = set(dict(model.named_parameters())) - set(params)
        if missing:
            raise KeyError(f"params lack {sorted(missing)[:5]}")
        state.update(params)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: (v.float() if v.is_floating_point() else v).detach().cpu()
                for k, v in state.items()}, path)
