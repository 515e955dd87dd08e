"""Vector quantization with a learned codebook (`quantizer_type: lookup`).

Counterpart of `maskbit_tpu/quantizers/vq.SimpleVectorizer`: the nearest
code by ||z||^2 + ||e||^2 - 2 z.e (one matrix product, in full float32 with
TF32 off, as the JAX package's `Precision.HIGHEST`: the argmin is sensitive
to near ties), optionally over L2-normalised latents and codes, the
commitment and codebook losses, the entropy term over -distances (only
with `train` and a non-zero `entropy_loss_weight`,
`ops.entropy.entropy_loss_fn`, the global batch's across data-parallel
processes), the straight-through estimator and `get_codebook_entry`. The codebook is `embedding.weight` (the original
repo's key).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from maskbit_tpu_torch.ops.entropy import entropy_loss_fn
from maskbit_tpu_torch.utils.precision import full_f32


class SimpleVectorizer(nn.Module):
    def __init__(self, codebook_size: int = 1024, token_size: int = 256,
                 commitment_cost: float = 0.25, entropy_loss_weight: float = 0.0,
                 entropy_loss_temperature: float = 0.01, entropy_gamma: float = 1.0,
                 use_l2_normalisation: bool = False):
        super().__init__()
        self.codebook_size, self.token_size = codebook_size, token_size
        self.commitment_cost = commitment_cost
        self.entropy_loss_weight = entropy_loss_weight
        self.entropy_loss_temperature = entropy_loss_temperature
        self.entropy_gamma = entropy_gamma
        self.use_l2_normalisation = use_l2_normalisation
        self.embedding = nn.Embedding(codebook_size, token_size)

    def _codebook(self) -> torch.Tensor:
        embedding = self.embedding.weight.float()
        return F.normalize(embedding, dim=-1) if self.use_l2_normalisation else embedding

    def forward(self, z: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Channels-last latents (b, h, w, D) -> (quantized latents through
        the straight-through estimator, float32; the losses and
        `min_encoding_indices`, int32 (b, h, w))."""
        z = z.float()
        if self.use_l2_normalisation:
            z = F.normalize(z, dim=-1)
        embedding = self._codebook()
        b, h, w, d = z.shape
        z_flat = z.reshape(-1, d)
        with full_f32():
            distances = (z_flat.pow(2).sum(dim=1, keepdim=True) + embedding.pow(2).sum(dim=1)
                         - 2.0 * (z_flat @ embedding.t()))
        indices = torch.argmin(distances, dim=1)
        z_quantized = embedding[indices].reshape(z.shape)

        commitment_loss = self.commitment_cost * torch.mean((z_quantized.detach() - z) ** 2)
        codebook_loss = torch.mean((z_quantized - z.detach()) ** 2)
        zero = z.new_zeros(())
        per_sample_entropy = avg_entropy = entropy_loss = zero
        if self.entropy_loss_weight != 0.0 and train:
            per_sample_entropy, avg_entropy = entropy_loss_fn(
                -distances, self.entropy_loss_temperature, self.entropy_gamma)
            entropy_loss = self.entropy_loss_weight * (per_sample_entropy - avg_entropy)
        loss = commitment_loss + codebook_loss + entropy_loss
        z_quantized = z + (z_quantized - z).detach()  # straight-through estimator
        return z_quantized, dict(
            quantizer_loss=loss, commitment_loss=commitment_loss, codebook_loss=codebook_loss,
            entropy_loss=entropy_loss, per_sample_entropy=per_sample_entropy,
            avg_entropy=avg_entropy,
            min_encoding_indices=indices.to(torch.int32).reshape(b, h, w))

    def get_codebook_entry(self, indices: torch.Tensor) -> torch.Tensor:
        """Indices (...,) -> codes (..., D), float32."""
        z_quantized = F.embedding(indices.long(), self.embedding.weight.float())
        return F.normalize(z_quantized, dim=-1) if self.use_l2_normalisation else z_quantized
