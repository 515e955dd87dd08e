"""VQGAN+ convolutional encoder and decoder.

Counterpart of `maskbit_tpu/nn/conv.py` (`ResidualBlock`, `ResidualStage`,
`DownsamplingStage`, `UpsamplingStage`, `ConvEncoder`, `ConvDecoder`).
Tensors are NCHW inside, in channels-last memory for cuDNN; the tokenizer
converts at its public boundary, which keeps the JAX package's NHWC. Kept
from the original repo and the JAX package:
  * GroupNorm(32, eps 1e-6) computed in float32;
  * the 1x1 `nin_shortcut` applied to the block's OUTPUT when in != out;
  * XLA's SAME padding, which is asymmetric for the stride-2 3x3
    downsampling conv: [pad // 2, pad - pad // 2], i.e. (0, 1) on an even
    input (torch's `padding='same'` refuses stride 2, and a symmetric pad
    of 1 shifts the sampling grid), so it is padded explicitly;
  * nearest-neighbour 2x upsampling;
  * `legacy` renames the decoder stages (`up.{i_level}` instead of
    `up.{position}`) and changes nothing else.
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
    """`layer` applied in x's dtype, with its own stride and padding."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.conv2d(x, layer.weight.to(x.dtype), bias, stride=layer.stride,
                    padding=layer.padding)


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """XLA's SAME padding of an NCHW tensor: out = ceil(size / stride), the
    total pad split as [pad // 2, pad - pad // 2] on each spatial axis."""
    pads = []
    for size in (x.shape[3], x.shape[2]):  # F.pad lists the last axis first
        total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


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


class DownsamplingStage(ResidualStage):
    def __init__(self, in_channels: int, out_channels: int, num_res_blocks: int,
                 sample_with_conv: bool = True):
        super().__init__(in_channels, out_channels, num_res_blocks)
        self.down_conv = (nn.Conv2d(out_channels, out_channels, 3, stride=2)
                          if sample_with_conv else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = super().forward(x)
        if self.down_conv is None:
            return F.avg_pool2d(x, 2)
        return conv(self.down_conv, same_pad(x, 3, 2))


class UpsamplingStage(ResidualStage):
    def __init__(self, in_channels: int, out_channels: int, num_res_blocks: int):
        super().__init__(in_channels, out_channels, num_res_blocks)
        self.upsample_conv = _conv3(out_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(super().forward(x), scale_factor=2, mode="nearest")
        return conv(self.upsample_conv, x)


class ConvEncoder(nn.Module):
    """Downstack: (b, 3, H, W) -> (b, token_size, H / 2^(L-1), W / 2^(L-1)), NCHW."""

    def __init__(self, num_channels: int = 3, hidden_channels: int = 128,
                 channel_mult: Sequence[int] = (1, 1, 2, 2, 4), num_resolutions: int = 5,
                 num_res_blocks: int = 2, token_size: int = 12, sample_with_conv: bool = True):
        super().__init__()
        self.conv_in = _conv3(num_channels, hidden_channels, bias=False)
        in_mult = (1,) + tuple(channel_mult)
        stages = []
        for i_level in range(num_resolutions):
            cin = hidden_channels * in_mult[i_level]
            cout = hidden_channels * in_mult[i_level + 1]
            if i_level < num_resolutions - 1:
                stages.append(DownsamplingStage(cin, cout, num_res_blocks, sample_with_conv))
            else:
                stages.append(ResidualStage(cin, cout, num_res_blocks))
        self.down = nn.ModuleList(stages)
        cout = hidden_channels * in_mult[num_resolutions]
        self.mid = ResidualStage(cout, cout, num_res_blocks)
        self.norm_out = _gn(cout)
        self.conv_out = nn.Conv2d(cout, token_size, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv(self.conv_in, x)
        for stage in self.down:
            x = stage(x)
        x = self.mid(x)
        return conv(self.conv_out, F.silu(group_norm_f32(self.norm_out, x)))


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
