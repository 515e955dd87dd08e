"""Weights carried across from the JAX package.

`generator_from_flax`, `tokenizer_from_flax` and `inception_from_flax` take
JAX parameter trees as numpy arrays, turn them into the original repo's state-dict layout with the
port's copy of the exporters (`compat/torch_export.py`, numpy only) and load
them strictly into the port's modules.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from maskbit_tpu_torch.compat.torch_export import (
    export_generator_state,
    export_inception_state,
    export_tokenizer_state,
)


def _to_tensors(state: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in state.items()}


def generator_from_flax(np_tree: Any, model: torch.nn.Module) -> torch.nn.Module:
    """Load a JAX LFQBert parameter tree into `model` (strict)."""
    state = export_generator_state(np_tree, model.codebook_splits)
    model.load_state_dict(_to_tensors(state), strict=True)
    return model


def tokenizer_from_flax(np_tree: Any, model: torch.nn.Module,
                        codebook_size: Optional[int] = None) -> torch.nn.Module:
    """Load a JAX ConvVQModel parameter tree into `model`: encoder, decoder
    and the quantizer (LFQ's buffers, rebuilt from `codebook_size`, or VQ's
    `quantize/embedding`), strict."""
    state = export_tokenizer_state(np_tree, codebook_size)
    model.load_state_dict(_to_tensors(state), strict=True)
    return model


def inception_from_flax(np_tree: Any, model: torch.nn.Module) -> torch.nn.Module:
    """Load a JAX InceptionV3 parameter tree into `model` (strict)."""
    model.load_state_dict(_to_tensors(export_inception_state(np_tree)), strict=True)
    return model
