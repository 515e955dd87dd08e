"""ConvVQModel, the Stage-I tokenizer with the lookup-free quantizer.

Counterpart of `maskbit_tpu/models/tokenizer.ConvVQModel` for Stage-II
training and generation: `from_config`, `encode` and `tokenize` (encoder ->
LFQ sign quantize), and `decode_tokens` (LFQ unpack -> decoder). The
Stage-I training forward (quantizer losses, straight-through estimator) and
the VQ quantizer are not ported yet. The public methods keep the JAX
package's layouts: NHWC images in [0, 1] and latents, integer tokens (b, h',
w') or (b, n). State dicts hold `encoder.*`, `decoder.*` and the
quantizer's buffers, and load strictly.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from maskbit_tpu_torch.nn.conv import ConvDecoder, ConvEncoder
from maskbit_tpu_torch.quantizers.lfq import LookupFreeQuantizer


class ConvVQModel(nn.Module):
    def __init__(self, num_channels: int = 3, hidden_channels: int = 128,
                 channel_mult: Sequence[int] = (1, 1, 2, 2, 4), num_resolutions: int = 5,
                 num_res_blocks: int = 2, num_res_blocks_decoder: Optional[int] = None,
                 token_size: int = 12, codebook_size: int = 4096,
                 quantizer_type: str = "lookup-free", sample_with_conv: bool = True,
                 legacy: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if quantizer_type != "lookup-free":
            raise NotImplementedError(
                f"quantizer_type {quantizer_type!r} is not ported to PyTorch yet")
        self.dtype, self.codebook_size = dtype, codebook_size
        self.encoder = ConvEncoder(num_channels, hidden_channels, tuple(channel_mult),
                                   num_resolutions, num_res_blocks, token_size,
                                   sample_with_conv)
        self.decoder = ConvDecoder(num_channels, hidden_channels, tuple(channel_mult),
                                   num_resolutions, num_res_blocks, token_size,
                                   num_res_blocks_decoder, legacy)
        self.quantize = LookupFreeQuantizer(token_size)

    @classmethod
    def from_config(cls, cfg, legacy: bool = False,
                    dtype: torch.dtype = torch.float32) -> "ConvVQModel":
        """Build from a `model.vq_model` config node."""
        return cls(
            num_channels=cfg.get("num_channels", 3),
            hidden_channels=cfg.get("hidden_channels", 128),
            channel_mult=tuple(cfg.get("channel_mult", (1, 1, 2, 2, 4))),
            num_resolutions=cfg.get("num_resolutions", 5),
            num_res_blocks=cfg.get("num_res_blocks", 2),
            num_res_blocks_decoder=cfg.get("num_res_blocks_decoder", None),
            token_size=cfg.get("token_size", 12),
            codebook_size=cfg.get("codebook_size", 4096),
            quantizer_type=cfg.get("quantizer_type", "lookup-free"),
            sample_with_conv=cfg.get("sample_with_conv", True),
            legacy=legacy,
            dtype=dtype,
        )

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """NHWC image (b, H, W, C) -> (quantized NHWC latent, quantizer dict)."""
        x = x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        z = self.encoder(x).permute(0, 2, 3, 1)
        return self.quantize(z)

    def tokenize(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image -> integer token grid (b, h', w'), int32."""
        return self.encode(x)[1]["min_encoding_indices"]

    def decode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Integer tokens (b, n) -> decoded NHWC image (b, H, W, 3)."""
        b, n = tokens.shape
        ss = math.isqrt(n)
        z = self.quantize.get_codebook_entry(tokens).reshape(b, ss, ss, -1)
        z = z.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        return self.decoder(z).permute(0, 2, 3, 1)
