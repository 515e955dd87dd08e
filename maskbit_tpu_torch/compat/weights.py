"""Weights carried across from the JAX package.

`generator_from_flax`, `tokenizer_from_flax`, `inception_from_flax`,
`discriminator_from_flax`, `perceptual_from_flax` (ResNet-50, ConvNeXt-S)
and `lpips_from_flax` take JAX parameter trees as numpy arrays, turn them
into the original repo's (or torchvision's) state-dict layout with the
port's copy of the exporters (`compat/torch_export.py`, numpy only) and
load them strictly into the port's modules.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from maskbit_tpu_torch.compat.torch_export import (
    export_convnext_small_state,
    export_discriminator_state,
    export_generator_state,
    export_inception_state,
    export_resnet50_state,
    export_tokenizer_state,
    export_vgg16_state,
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


def discriminator_from_flax(np_tree: Any, model: torch.nn.Module) -> torch.nn.Module:
    """Load a JAX discriminator parameter tree (v2 or Pix2Pix) into `model`,
    strict; the v2 blur's buffers come from the model's own kernel size."""
    from maskbit_tpu_torch.nn.discriminator import BlurBlock

    blur = [m for m in model.modules() if isinstance(m, BlurBlock)]
    state = export_discriminator_state(np_tree, len(blur[0].taps) if blur else None)
    model.load_state_dict(_to_tensors(state), strict=True)
    return model


def perceptual_from_flax(np_tree: Any, loss: torch.nn.Module) -> torch.nn.Module:
    """Load the JAX package's `PerceptualLoss` params (ResNet-50 or
    ConvNeXt-S under `model`) into the port's `PerceptualLoss`, strict."""
    from maskbit_tpu_torch.losses.convnext import ConvNeXtSmall

    export = (export_convnext_small_state if isinstance(loss.model, ConvNeXtSmall)
              else export_resnet50_state)
    loss.model.load_state_dict(_to_tensors(export(np_tree)), strict=True)
    return loss


def lpips_from_flax(np_tree: Any, model: torch.nn.Module) -> torch.nn.Module:
    """Load the JAX package's LPIPS params (`net/conv_*`, `lin_*`) into the
    port's `LPIPS`, strict."""
    from maskbit_tpu_torch.losses.lpips import lin_state_from_flax, vgg16_state_to_lpips

    params = np_tree.get("params", np_tree)
    state = dict(lin_state_from_flax(params),
                 **vgg16_state_to_lpips(_to_tensors(export_vgg16_state(params["net"]))))
    state.update({f"scaling_layer.{k}": v for k, v in model.scaling_layer.state_dict().items()})
    model.load_state_dict(state, strict=True)
    return model
