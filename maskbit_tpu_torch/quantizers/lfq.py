"""Lookup-Free Quantization: latents -> ±1 bit codes -> token indices, and back.

Counterpart of `maskbit_tpu/quantizers/lfq.LookupFreeQuantizer`: the
quantize (sign -> ±1 -> LSB-first `min_encoding_indices`), the commitment
loss, the full-codebook entropy loss (only with `train` and a non-zero
`entropy_loss_weight`; streamed over codebook chunks by
`ops.entropy.lfq_entropy_terms`), the straight-through estimator
z + (z_q - z).detach(), and `get_codebook_entry`. The original repo's
registered buffers `bits_to_indices` and `codebook` are kept so that state
dicts load strictly.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from maskbit_tpu_torch.ops import bitops
from maskbit_tpu_torch.ops.entropy import lfq_entropy_terms


class LookupFreeQuantizer(nn.Module):
    def __init__(self, token_bits: int = 10, commitment_cost: float = 0.25,
                 entropy_loss_weight: float = 0.1, entropy_loss_temperature: float = 0.01,
                 entropy_gamma: float = 1.0, entropy_chunk_size: int = 4096):
        super().__init__()
        self.token_bits = token_bits
        self.commitment_cost = commitment_cost
        self.entropy_loss_weight = entropy_loss_weight
        self.entropy_loss_temperature = entropy_loss_temperature
        self.entropy_gamma = entropy_gamma
        self.entropy_chunk_size = entropy_chunk_size
        self.register_buffer("bits_to_indices", torch.empty(token_bits, dtype=torch.int32))
        self.register_buffer("codebook", torch.empty(2**token_bits, token_bits))
        self.reset_buffers()

    def reset_buffers(self) -> None:
        """Rebuild the deterministic buffers (after `to_empty`)."""
        self.bits_to_indices.copy_(bitops.bit_weights(self.token_bits))
        self.codebook.copy_(bitops.codebook(self.token_bits))

    def forward(self, z: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Channels-last latents (..., K) -> (±1 codes in float32 through the
        straight-through estimator, the result dict: `quantizer_loss`,
        `commitment_loss`, `entropy_loss`, `per_sample_entropy`,
        `avg_entropy`, `min_encoding_indices` int32 (...,)). A latent of
        exactly 0 quantizes to -1, as in the JAX package."""
        z = z.float()
        z_quantized = torch.where(z > 0.0, 1.0, -1.0)
        min_encoding_indices = bitops.bits_to_indices(z_quantized)
        commitment_loss = self.commitment_cost * torch.mean((z_quantized - z) ** 2)
        zero = z.new_zeros(())
        per_sample_entropy = avg_entropy = entropy_loss = zero
        if self.entropy_loss_weight != 0.0 and train:
            per_sample_entropy, avg_entropy = lfq_entropy_terms(
                z, self.token_bits, self.entropy_loss_temperature, self.entropy_gamma,
                self.entropy_chunk_size)
            entropy_loss = self.entropy_loss_weight * (per_sample_entropy - avg_entropy)
        z_quantized = z + (z_quantized - z).detach()  # straight-through estimator
        return z_quantized, dict(
            quantizer_loss=commitment_loss + entropy_loss, commitment_loss=commitment_loss,
            entropy_loss=entropy_loss, per_sample_entropy=per_sample_entropy,
            avg_entropy=avg_entropy, min_encoding_indices=min_encoding_indices)

    def get_codebook_entry(self, indices: torch.Tensor) -> torch.Tensor:
        """Indices (...,) -> ±1 bit codes (..., K), float32."""
        return bitops.indices_to_bits(indices, self.token_bits)
