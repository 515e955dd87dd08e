"""ConvVQModel, the Stage-I tokenizer: encoder -> quantizer -> decoder.

Counterpart of `maskbit_tpu/models/tokenizer.ConvVQModel`: `from_config`,
`encode` and `tokenize` (encoder -> quantize), `decode`, `decode_tokens`
(codes -> decoder) and the forward (reconstruction and the quantizer's dict
with `z_quantized`). `train=True` gives the quantizer's training losses
(the entropy term); `finetune_decoder` runs the encoder as a frozen
feature extractor: the latent is detached and the quantizer's losses are
multiplied by 0, so only the decoder trains. The quantizer
is chosen as `_make_quantizer` does in JAX: `lookup-free` (LFQ, no
parameters) or `lookup` (VQ, `quantize.embedding.weight`). The public methods keep
the JAX package's layouts: NHWC images in [0, 1] and latents, integer
tokens (b, h', w') or (b, n). State dicts hold `encoder.*`, `decoder.*` and
the quantizer's parameters or buffers, and load strictly.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from maskbit_tpu_torch.nn.conv import ConvDecoder, ConvEncoder, init_flax_defaults_
from maskbit_tpu_torch.quantizers.lfq import LookupFreeQuantizer
from maskbit_tpu_torch.quantizers.vq import SimpleVectorizer


def _make_quantizer(quantizer_type: str, token_size: int, codebook_size: int,
                    entropy_chunk_size: int, use_l2_normalisation: bool, **kwargs) -> nn.Module:
    if quantizer_type == "lookup":
        return SimpleVectorizer(codebook_size, token_size,
                                use_l2_normalisation=use_l2_normalisation, **kwargs)
    if quantizer_type == "lookup-free":
        return LookupFreeQuantizer(token_size, entropy_chunk_size=entropy_chunk_size, **kwargs)
    if quantizer_type == "vae":
        raise NotImplementedError("VAE bottleneck is not supported (matches reference).")
    raise ValueError(f"Unknown vector quantizer class {quantizer_type!r}")


class ConvVQModel(nn.Module):
    def __init__(self, num_channels: int = 3, hidden_channels: int = 128,
                 channel_mult: Sequence[int] = (1, 1, 2, 2, 4), num_resolutions: int = 5,
                 num_res_blocks: int = 2, num_res_blocks_decoder: Optional[int] = None,
                 token_size: int = 12, codebook_size: int = 4096,
                 quantizer_type: str = "lookup-free", commitment_cost: float = 0.25,
                 entropy_loss_weight: float = 0.0, entropy_loss_temperature: float = 0.01,
                 entropy_gamma: float = 1.0, entropy_chunk_size: int = 4096,
                 use_l2_normalisation: bool = False, sample_with_conv: bool = True,
                 legacy: bool = False, finetune_decoder: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.codebook_size = dtype, codebook_size
        self.finetune_decoder = finetune_decoder
        self.encoder = ConvEncoder(num_channels, hidden_channels, tuple(channel_mult),
                                   num_resolutions, num_res_blocks, token_size,
                                   sample_with_conv)
        self.decoder = ConvDecoder(num_channels, hidden_channels, tuple(channel_mult),
                                   num_resolutions, num_res_blocks, token_size,
                                   num_res_blocks_decoder, legacy)
        self.quantize = _make_quantizer(
            quantizer_type, token_size, codebook_size, commitment_cost=commitment_cost,
            entropy_loss_weight=entropy_loss_weight,
            entropy_loss_temperature=entropy_loss_temperature, entropy_gamma=entropy_gamma,
            entropy_chunk_size=entropy_chunk_size, use_l2_normalisation=use_l2_normalisation)

    @classmethod
    def from_config(cls, cfg, legacy: bool = False, finetune_decoder: Optional[bool] = None,
                    dtype: torch.dtype = torch.float32) -> "ConvVQModel":
        """Build from a `model.vq_model` config node."""
        if finetune_decoder is None:
            finetune_decoder = cfg.get("finetune_decoder", False)
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
            commitment_cost=cfg.get("commitment_cost", 0.25),
            entropy_loss_weight=cfg.get("entropy_loss_weight", 0.0),
            entropy_loss_temperature=cfg.get("entropy_loss_temperature", 0.01),
            entropy_gamma=cfg.get("entropy_gamma", 1.0),
            entropy_chunk_size=cfg.get("entropy_chunk_size", 4096),
            use_l2_normalisation=cfg.get("use_l2_normalisation", False),
            sample_with_conv=cfg.get("sample_with_conv", True),
            legacy=legacy,
            finetune_decoder=finetune_decoder,
            dtype=dtype,
        )

    def encode(self, x: torch.Tensor, train: bool = False
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """NHWC image (b, H, W, C) -> (quantized NHWC latent, quantizer dict)."""
        x = x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        z = self.encoder(x).permute(0, 2, 3, 1)
        return self.quantize(z, train=train)

    def tokenize(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image -> integer token grid (b, h', w'), int32."""
        return self.encode(x)[1]["min_encoding_indices"]

    def decode(self, z_quantized: torch.Tensor) -> torch.Tensor:
        """NHWC latents (b, h', w', K) -> decoded NHWC image (b, H, W, 3), in
        the compute dtype."""
        z = z_quantized.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        return self.decoder(z).permute(0, 2, 3, 1)

    def decode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Integer tokens (b, n) -> decoded NHWC image (b, H, W, 3)."""
        b, n = tokens.shape
        ss = math.isqrt(n)
        return self.decode(self.quantize.get_codebook_entry(tokens).reshape(b, ss, ss, -1))

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """NHWC image -> (reconstruction, the quantizer's dict with the
        latent as `z_quantized`)."""
        if self.finetune_decoder:
            z_quantized, result = self._finetuning_encoder_forward(x)
        else:
            z_quantized, result = self.encode(x, train=train)
        return self.decode(z_quantized), dict(result, z_quantized=z_quantized)

    def _finetuning_encoder_forward(self, x: torch.Tensor
                                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The frozen encoder's latent (no graph is kept) and the quantizer's
        dict with its losses multiplied by 0."""
        with torch.no_grad():
            z_quantized, result = self.encode(x, train=False)
        for key in ("quantizer_loss", "commitment_loss", "codebook_loss", "entropy_loss"):
            if key in result:
                result[key] = result[key] * 0.0
        return z_quantized, result


@torch.no_grad()
def init_tokenizer_weights_(model: ConvVQModel, generator: torch.Generator) -> None:
    """The JAX package's initialisation (flax's defaults, drawn from
    `generator`): conv kernels lecun-normal, biases 0, GroupNorm scales 1;
    a VQ codebook uniform in [-1/N, 1/N)."""
    init_flax_defaults_(model, generator)
    if isinstance(model.quantize, SimpleVectorizer):
        n = model.quantize.codebook_size
        model.quantize.embedding.weight.uniform_(-1.0 / n, 1.0 / n, generator=generator)
