"""ConvVQModel, the decode half of the Stage-I tokenizer.

Counterpart of `maskbit_tpu/models/tokenizer.ConvVQModel` for generation:
`from_config` and `decode_tokens` with the lookup-free quantizer. The
encoder, VQ quantizer and training forward are not ported yet.
`decode_tokens` keeps the JAX package's layouts: integer tokens (b, n) in,
NHWC images (b, H, W, 3) out.
"""

from __future__ import annotations

import logging
import math
from typing import Mapping, Optional, Sequence

import torch
from torch import nn

from maskbit_tpu_torch.nn.conv import ConvDecoder
from maskbit_tpu_torch.quantizers.lfq import LookupFreeQuantizer

_logger = logging.getLogger("maskbit_tpu_torch")


class ConvVQModel(nn.Module):
    def __init__(self, num_channels: int = 3, hidden_channels: int = 128,
                 channel_mult: Sequence[int] = (1, 1, 2, 2, 4), num_resolutions: int = 5,
                 num_res_blocks: int = 2, num_res_blocks_decoder: Optional[int] = None,
                 token_size: int = 12, codebook_size: int = 4096,
                 quantizer_type: str = "lookup-free", legacy: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if quantizer_type != "lookup-free":
            raise NotImplementedError(
                f"quantizer_type {quantizer_type!r} is not ported to PyTorch yet")
        self.dtype = dtype
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
            legacy=legacy,
            dtype=dtype,
        )

    def load_decoder_state(self, state: Mapping[str, torch.Tensor]) -> None:
        """Load `decoder.*` and `quantize.*` strictly; skip the encoder's
        keys of a full tokenizer checkpoint, naming them in one log line."""
        skipped = sorted(k for k in state if k.startswith("encoder."))
        if skipped:
            _logger.info("tokenizer: skipping %d encoder keys (decoder-only port): %s",
                         len(skipped), ", ".join(skipped))
        self.load_state_dict({k: v for k, v in state.items()
                              if not k.startswith("encoder.")}, strict=True)

    def decode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Integer tokens (b, n) -> decoded NHWC image (b, H, W, 3)."""
        b, n = tokens.shape
        ss = math.isqrt(n)
        z = self.quantize.get_codebook_entry(tokens).reshape(b, ss, ss, -1)
        z = z.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        return self.decoder(z).permute(0, 2, 3, 1)
