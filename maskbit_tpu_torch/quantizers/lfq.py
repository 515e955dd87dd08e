"""Lookup-Free Quantization, the decode half: indices -> ±1 bit codes.

Counterpart of `maskbit_tpu/quantizers/lfq.LookupFreeQuantizer`'s
`get_codebook_entry`. The original repo's registered buffers
`bits_to_indices` and `codebook` are kept so that state dicts load strictly.
Quantization, the entropy loss and the straight-through estimator are not
ported yet (Stage-I training).
"""

from __future__ import annotations

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

    def get_codebook_entry(self, indices: torch.Tensor) -> torch.Tensor:
        """Indices (...,) -> ±1 bit codes (..., K), float32."""
        return bitops.indices_to_bits(indices, self.token_bits)
