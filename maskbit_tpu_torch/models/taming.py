"""The Taming-Transformers VQGAN (CompVis), an external baseline tokenizer.

Counterpart of `maskbit_tpu/models/taming.py` (`OriginalVQModel` and its
encoder and decoder). Module names follow the CompVis state dict
(`encoder.down.{i}.block.{j}`, `encoder.down.{i}.attn.{j}`,
`encoder.mid.block_1` / `attn_1` / `block_2`, `decoder.up.{i}.*` indexed by
resolution level, `quant_conv`, `post_quant_conv`, `quantize.embedding`),
so a taming checkpoint loads strictly once its bundled `loss.*` keys are
dropped (`core.checkpoint.load_pretrained` drops them).

* `ResnetBlock`: GroupNorm(32, eps 1e-6) in float32, swish, 3x3 convs, and
  a 1x1 `nin_shortcut` on the block's INPUT when the widths differ;
* `AttnBlock`: single-head spatial self-attention over the h*w grid with
  1x1 `q`, `k`, `v` and `proj_out`, the scores in the compute dtype and the
  softmax in float32 (a plain product, as in the JAX package);
* `Downsample`: a (0, 1) pad on the bottom and right, then a VALID stride-2
  3x3 conv; `Upsample`: nearest 2x, then a 3x3 conv;
* the quantizer is the port's `SimpleVectorizer` (1024 x 256 by default);
* images are NHWC in [0, 1] at the public methods, scaled to [-1, 1] inside;
  tensors are NCHW in channels-last memory between them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from maskbit_tpu_torch.nn.conv import conv, group_norm_f32
from maskbit_tpu_torch.quantizers.vq import SimpleVectorizer


def _norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, channels, eps=1e-6)


def _conv3(cin: int, cout: int, stride: int = 1, padding: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=padding)


def _swish_norm(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    return F.silu(group_norm_f32(norm, x))


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = _norm(in_channels)
        self.conv1 = _conv3(in_channels, out_channels)
        self.norm2 = _norm(out_channels)
        self.conv2 = _conv3(out_channels, out_channels)
        self.nin_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                             if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv(self.conv1, _swish_norm(self.norm1, x))
        h = conv(self.conv2, _swish_norm(self.norm2, h))
        return (x if self.nin_shortcut is None else conv(self.nin_shortcut, x)) + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention over the h*w grid."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.norm = _norm(in_channels)
        self.q = nn.Conv2d(in_channels, in_channels, 1)
        self.k = nn.Conv2d(in_channels, in_channels, 1)
        self.v = nn.Conv2d(in_channels, in_channels, 1)
        self.proj_out = nn.Conv2d(in_channels, in_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = group_norm_f32(self.norm, x)

        def tokens(layer):  # (b, h*w, c)
            return conv(layer, y).permute(0, 2, 3, 1).reshape(b, h * w, c)

        q, k, v = tokens(self.q), tokens(self.k), tokens(self.v)
        scores = torch.matmul(q, k.transpose(1, 2)) * (c**-0.5)
        attn = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + conv(self.proj_out, out.contiguous(memory_format=torch.channels_last))


class Downsample(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.conv = _conv3(in_channels, in_channels, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(self.conv, F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.conv = _conv3(in_channels, in_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(self.conv, F.interpolate(x, scale_factor=2, mode="nearest"))


class _Level(nn.Module):
    """One resolution level: `block.{j}`, `attn.{j}` after each block where
    the level has attention, then `downsample`, `upsample` or neither."""

    def __init__(self, specs: Sequence[Tuple[int, int]], use_attn: bool,
                 resample: Optional[str] = None):
        super().__init__()
        self.block = nn.ModuleList(ResnetBlock(cin, cout) for cin, cout in specs)
        self.attn = nn.ModuleList(AttnBlock(cout) for _, cout in specs) if use_attn else None
        self.resample = resample
        if resample == "down":
            self.downsample = Downsample(specs[-1][1])
        elif resample == "up":
            self.upsample = Upsample(specs[-1][1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j, block in enumerate(self.block):
            x = block(x)
            if self.attn is not None:
                x = self.attn[j](x)
        if self.resample == "down":
            x = self.downsample(x)
        elif self.resample == "up":
            x = self.upsample(x)
        return x


class _Mid(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.block_1 = ResnetBlock(channels, channels)
        self.attn_1 = AttnBlock(channels)
        self.block_2 = ResnetBlock(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(x)))


class TamingEncoder(nn.Module):
    """(b, 3, H, W) in [-1, 1] -> (b, z_channels, H / 2^(L-1), W / 2^(L-1))."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 1, 2, 2, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (16,),
                 resolution: int = 256, z_channels: int = 256, in_channels: int = 3):
        super().__init__()
        levels = len(ch_mult)
        in_ch_mult = (1,) + tuple(ch_mult)
        self.conv_in = _conv3(in_channels, ch)
        curr_res, down = resolution, []
        for i_level in range(levels):
            cin, cout = ch * in_ch_mult[i_level], ch * ch_mult[i_level]
            specs = [(cin if j == 0 else cout, cout) for j in range(num_res_blocks)]
            last = i_level == levels - 1
            down.append(_Level(specs, curr_res in attn_resolutions, None if last else "down"))
            if not last:
                curr_res //= 2
        self.down = nn.ModuleList(down)
        block_in = ch * ch_mult[-1]
        self.mid = _Mid(block_in)
        self.norm_out = _norm(block_in)
        self.conv_out = _conv3(block_in, z_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv(self.conv_in, x)
        for level in self.down:
            x = level(x)
        return conv(self.conv_out, _swish_norm(self.norm_out, self.mid(x)))


class TamingDecoder(nn.Module):
    """(b, z_channels, h, w) -> (b, 3, h * 2^(L-1), w * 2^(L-1)) in [-1, 1]."""

    def __init__(self, ch: int = 128, out_ch: int = 3, ch_mult: Sequence[int] = (1, 1, 2, 2, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (16,),
                 resolution: int = 256, z_channels: int = 256):
        super().__init__()
        levels = len(ch_mult)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (levels - 1)
        self.conv_in = _conv3(z_channels, block_in)
        self.mid = _Mid(block_in)
        up, cin = {}, block_in
        for i_level in reversed(range(levels)):
            cout = ch * ch_mult[i_level]
            specs = [(cin if j == 0 else cout, cout) for j in range(num_res_blocks + 1)]
            up[i_level] = _Level(specs, curr_res in attn_resolutions,
                                 "up" if i_level != 0 else None)
            cin = cout
            if i_level != 0:
                curr_res *= 2
        self.up = nn.ModuleList(up[i] for i in range(levels))  # indexed by level
        self.norm_out = _norm(cin)
        self.conv_out = _conv3(cin, out_ch)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid(conv(self.conv_in, z))
        for level in reversed(self.up):
            x = level(x)
        return conv(self.conv_out, _swish_norm(self.norm_out, x))


class OriginalVQModel(nn.Module):
    """The taming VQGAN: [-1, 1] scaling, encoder, `quant_conv`, VQ,
    `post_quant_conv`, decoder."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 1, 2, 2, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (16,),
                 resolution: int = 256, z_channels: int = 256, codebook_size: int = 1024,
                 token_size: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.codebook_size = dtype, codebook_size
        args = dict(ch=ch, ch_mult=tuple(ch_mult), num_res_blocks=num_res_blocks,
                    attn_resolutions=tuple(attn_resolutions), resolution=resolution,
                    z_channels=z_channels)
        self.encoder = TamingEncoder(**args)
        self.decoder = TamingDecoder(**args)
        self.quantize = SimpleVectorizer(codebook_size, token_size, commitment_cost=0.25)
        self.quant_conv = nn.Conv2d(z_channels, token_size, 1)
        self.post_quant_conv = nn.Conv2d(token_size, z_channels, 1)

    @classmethod
    def from_config(cls, cfg, dtype: torch.dtype = torch.float32) -> "OriginalVQModel":
        """Build from a `model.vq_model` config node (the JAX package's
        `cli/eval_tokenizer` keys and defaults)."""
        return cls(
            ch=cfg.get("hidden_channels", 128),
            ch_mult=tuple(cfg.get("channel_mult", (1, 1, 2, 2, 4))),
            num_res_blocks=cfg.get("num_res_blocks", 2),
            attn_resolutions=tuple(cfg.get("attn_resolutions", (16,))),
            resolution=cfg.get("resolution", 256),
            z_channels=cfg.get("z_channels", 256),
            codebook_size=cfg.get("codebook_size", 1024),
            token_size=cfg.get("token_size", 256),
            dtype=dtype,
        )

    def encode(self, x: torch.Tensor, train: bool = False
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """NHWC image in [0, 1] -> (quantized NHWC latent, the quantizer's dict)."""
        x = (x * 2.0 - 1.0).permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        z = conv(self.quant_conv, self.encoder(x)).permute(0, 2, 3, 1)
        return self.quantize(z, train=train)

    def decode(self, z_quantized: torch.Tensor) -> torch.Tensor:
        """NHWC latents (b, h, w, token_size) -> NHWC image in [0, 1]
        (nominally), in the compute dtype."""
        z = z_quantized.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        decoded = self.decoder(conv(self.post_quant_conv, z)).permute(0, 2, 3, 1)
        return (decoded + 1.0) / 2.0

    def tokenize(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image -> integer token grid (b, h, w), int32."""
        return self.encode(x)[1]["min_encoding_indices"]

    def decode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Integer tokens (b, n) -> NHWC image."""
        b, n = tokens.shape
        ss = math.isqrt(n)
        return self.decode(self.quantize.get_codebook_entry(tokens).reshape(b, ss, ss, -1))

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """NHWC image -> (reconstruction, the quantizer's dict)."""
        z_quantized, result = self.encode(x, train=train)
        return self.decode(z_quantized), result

