"""VQGAN+ convolutional decoder, inference only.

Counterpart of `maskbit_tpu/nn/conv.py` (`ResidualBlock`, `ResidualStage`,
`UpsamplingStage`, `ConvDecoder`). Tensors are NCHW inside, in channels-last
memory for cuDNN; the tokenizer converts at its public boundary, which keeps
the JAX package's NHWC. Kept from the original repo:
  * GroupNorm(32, eps 1e-6) computed in float32;
  * the 1x1 `nin_shortcut` applied to the block's OUTPUT when in != out;
  * nearest-neighbour 2x upsampling;
  * `legacy` renames the decoder stages (`up.{i_level}` instead of
    `up.{position}`) and changes nothing else.
The encoder side (`ConvEncoder`, `DownsamplingStage`) is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def group_norm_f32(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm computed in float32, cast back to x's dtype."""
    return F.group_norm(x.float(), norm.num_groups, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


def conv(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`layer` applied in x's dtype (stride 1, SAME padding)."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.conv2d(x, layer.weight.to(x.dtype), bias, padding=layer.padding)


def _conv3(cin: int, cout: int, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=bias)


def _gn(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, channels, eps=1e-6)


class ResidualBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: Optional[int] = None):
        super().__init__()
        out_channels = in_channels if out_channels is None else out_channels
        self.norm1 = _gn(in_channels)
        self.conv1 = _conv3(in_channels, out_channels, bias=False)
        self.norm2 = _gn(out_channels)
        self.conv2 = _conv3(out_channels, out_channels, bias=False)
        if in_channels != out_channels:
            self.nin_shortcut = nn.Conv2d(out_channels, out_channels, 1, bias=False)
        else:
            self.nin_shortcut = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv(self.conv1, F.silu(group_norm_f32(self.norm1, x)))
        h = conv(self.conv2, F.silu(group_norm_f32(self.norm2, h)))
        residual = x if self.nin_shortcut is None else conv(self.nin_shortcut, h)
        return h + residual


class ResidualStage(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_res_blocks: int):
        super().__init__()
        self.res_blocks = nn.ModuleList(
            ResidualBlock(in_channels if i == 0 else out_channels, out_channels)
            for i in range(num_res_blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.res_blocks:
            x = block(x)
        return x


class UpsamplingStage(ResidualStage):
    def __init__(self, in_channels: int, out_channels: int, num_res_blocks: int):
        super().__init__(in_channels, out_channels, num_res_blocks)
        self.upsample_conv = _conv3(out_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(super().forward(x), scale_factor=2, mode="nearest")
        return conv(self.upsample_conv, x)


class ConvDecoder(nn.Module):
    """Mirror upstack: (b, token_size, h, w) -> (b, 3, 16h, 16w), NCHW."""

    def __init__(self, num_channels: int = 3, hidden_channels: int = 128,
                 channel_mult: Sequence[int] = (1, 1, 2, 2, 4), num_resolutions: int = 5,
                 num_res_blocks: int = 2, token_size: int = 12,
                 num_res_blocks_decoder: Optional[int] = None, legacy: bool = False):
        super().__init__()
        # explicit None check: num_res_blocks_decoder: 0 is honoured
        if not legacy and num_res_blocks_decoder is not None:
            num_res_blocks = num_res_blocks_decoder
        block_in = hidden_channels * channel_mult[num_resolutions - 1]
        in_mult = tuple(channel_mult) + (channel_mult[-1],)

        self.conv_in = _conv3(token_size, block_in)
        self.mid = ResidualStage(block_in, block_in, num_res_blocks)
        # Stages run from the lowest resolution up. The non-legacy decoder
        # names them by position; the legacy one by i_level.
        stages = {}
        for pos, i_level in enumerate(reversed(range(num_resolutions))):
            cin = hidden_channels * in_mult[i_level + 1]
            cout = hidden_channels * in_mult[i_level]
            stage_cls = UpsamplingStage if i_level > 0 else ResidualStage
            stages[i_level if legacy else pos] = stage_cls(cin, cout, num_res_blocks)
        self.up = nn.ModuleList(stages[i] for i in range(num_resolutions))
        self.order = (list(reversed(range(num_resolutions))) if legacy
                      else list(range(num_resolutions)))
        self.norm_out = _gn(hidden_channels * in_mult[0])
        self.conv_out = _conv3(hidden_channels * in_mult[0], num_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid(conv(self.conv_in, z))
        for i in self.order:
            x = self.up[i](x)
        return conv(self.conv_out, F.silu(group_norm_f32(self.norm_out, x)))
