"""Lookup-Free Quantization: latents -> ±1 bit codes -> token indices, and back.

Counterpart of `maskbit_tpu/quantizers/lfq.LookupFreeQuantizer`: the
forward quantize (sign -> ±1 -> LSB-first `min_encoding_indices`) and
`get_codebook_entry`. The original repo's registered buffers
`bits_to_indices` and `codebook` are kept so that state dicts load strictly.
The commitment and entropy losses and the straight-through estimator come
with Stage-I training and are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from maskbit_tpu_torch.ops import bitops


class LookupFreeQuantizer(nn.Module):
    def __init__(self, token_bits: int = 10):
        super().__init__()
        self.token_bits = token_bits
        self.register_buffer("bits_to_indices", torch.empty(token_bits, dtype=torch.int32))
        self.register_buffer("codebook", torch.empty(2**token_bits, token_bits))
        self.reset_buffers()

    def reset_buffers(self) -> None:
        """Rebuild the deterministic buffers (after `to_empty`)."""
        self.bits_to_indices.copy_(bitops.bit_weights(self.token_bits))
        self.codebook.copy_(bitops.codebook(self.token_bits))

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Channels-last latents (..., K) -> (±1 codes in float32,
        {"min_encoding_indices": int32 (...,)}); a latent of exactly 0
        quantizes to -1, as in the JAX package."""
        z_quantized = torch.where(z.float() > 0.0, 1.0, -1.0)
        return z_quantized, {"min_encoding_indices": bitops.bits_to_indices(z_quantized)}

    def get_codebook_entry(self, indices: torch.Tensor) -> torch.Tensor:
        """Indices (...,) -> ±1 bit codes (..., K), float32."""
        return bitops.indices_to_bits(indices, self.token_bits)
