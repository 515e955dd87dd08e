"""Weights carried across from the JAX package.

`generator_from_flax` and `tokenizer_from_flax` take JAX parameter trees as
numpy arrays, turn them into the original repo's state-dict layout with the
JAX package's own exporters (`maskbit_tpu/compat/torch_export.py`, numpy
only) and load them strictly into the port's modules.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _to_tensors(state: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in state.items()}


def generator_from_flax(np_tree: Any, model: torch.nn.Module) -> torch.nn.Module:
    """Load a JAX LFQBert parameter tree into `model` (strict)."""
    from maskbit_tpu.compat.torch_export import export_generator_state

    state = export_generator_state(np_tree, model.codebook_splits)
    model.load_state_dict(_to_tensors(state), strict=True)
    return model


def tokenizer_from_flax(np_tree: Any, model: torch.nn.Module,
                        codebook_size: int) -> torch.nn.Module:
    """Load a JAX ConvVQModel parameter tree into the decode-only `model`
    (decoder and quantizer strict; the encoder's keys are skipped)."""
    from maskbit_tpu.compat.torch_export import export_tokenizer_state

    model.load_decoder_state(_to_tensors(export_tokenizer_state(np_tree, codebook_size)))
    return model
