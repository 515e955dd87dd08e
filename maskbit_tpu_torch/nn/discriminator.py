"""PatchGAN discriminators of Stage-I training.

Counterpart of `maskbit_tpu/nn/discriminator.py`, NCHW inside (channels-last
memory) and NHWC at the public boundary, as the tokenizer:
  * `blur_pool_2d`: an anti-aliased 2x downsample, a depthwise stride-2
    convolution with the normalised outer product of (1, 2, 1),
    (1, 3, 3, 1) or (1, 4, 6, 4, 1), after XLA's SAME padding, which is
    symmetric (1, 1) for 4 taps but (0, 1) for 3 and (1, 2) for 5 on an
    even input, so it is padded explicitly;
  * `adaptive_max_pool_2d` to 16x16, for sizes that divide (the JAX
    package's restriction);
  * `NLayerDiscriminatorv2`: 5x5 conv in, per stage a 3x3 conv, average
    pool or blur, GroupNorm(32, eps 1e-5, torch's default and not the
    autoencoder's 1e-6) computed in float32, LeakyReLU(0.1) or SiLU; the
    16x16 max pool; a 1x1 and a 5x5 conv to logits;
  * `OriginalNLayerDiscriminator`: the Pix2Pix PatchGAN with BatchNorm. Its
    BatchNorm normalises by the batch's statistics on every call, as the
    JAX package's (torch's train mode), in float32; its running averages are
    neither updated nor read.
State dicts use the original repo's keys: `block_in.0`, `blocks.{i}.0`
(conv), `blocks.{i}.1.kernel` (the blur, a buffer), `blocks.{i}.2`
(GroupNorm), `to_logits.0|2`; `main.{i}` for the Pix2Pix Sequential.
`init_discriminator_weights_` draws the JAX package's initialisation.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from maskbit_tpu_torch.nn.blur import BLUR_KERNEL_MAP, blur_kernel
from maskbit_tpu_torch.nn.conv import conv, group_norm_f32, init_flax_defaults_, same_pad


def blur_pool_2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise stride-2 blur of NCHW x with SAME padding; `kernel` is
    (1, 1, k, k)."""
    c, k = x.shape[1], kernel.shape[-1]
    weight = kernel.to(x.dtype).expand(c, 1, k, k)
    return F.conv2d(same_pad(x, k, 2), weight, stride=2, groups=c)


def adaptive_max_pool_2d(x: torch.Tensor, output_size: Tuple[int, int]) -> torch.Tensor:
    """AdaptiveMaxPool2d of NCHW x where the output size divides the input's."""
    h, w = x.shape[2], x.shape[3]
    oh, ow = output_size
    if (h, w) == (oh, ow):
        return x
    if h % oh or w % ow:
        raise ValueError(f"adaptive_max_pool_2d requires divisible sizes, got {(h, w)} -> {(oh, ow)}")
    return F.max_pool2d(x, (h // oh, w // ow))


class BlurBlock(nn.Module):
    def __init__(self, taps: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        self.taps = tuple(taps)
        self.register_buffer("kernel", torch.from_numpy(blur_kernel(self.taps)))

    def reset_buffers(self) -> None:
        self.kernel.copy_(torch.from_numpy(blur_kernel(self.taps)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return blur_pool_2d(x, self.kernel)


class _AvgPool(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(x, 2)


class _Act(nn.Module):
    """A parameterless slot, so that Sequential indices match the original."""


def _activation(name: str):
    if name == "leaky_relu":
        return lambda x: F.leaky_relu(x, 0.1)
    return F.silu


class NLayerDiscriminatorv2(nn.Module):
    def __init__(self, num_channels: int = 3, hidden_channels: int = 64, num_stages: int = 3,
                 activation_fn: str = "leaky_relu", blur_resample: bool = False,
                 blur_kernel_size: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_stages <= 0:
            raise ValueError("Discriminator cannot have 0 stages")
        self.dtype = dtype
        self.act = _activation(activation_fn)
        in_channel_mult = (1,) + tuple(2**t for t in range(num_stages))
        self.block_in = nn.Sequential(nn.Conv2d(num_channels, hidden_channels, 5, padding=2),
                                      _Act())
        blocks = []
        for i_level in range(num_stages):
            cin = hidden_channels * in_channel_mult[i_level]
            cout = hidden_channels * in_channel_mult[i_level + 1]
            blocks.append(nn.Sequential(
                nn.Conv2d(cin, cout, 3, padding=1),
                BlurBlock(BLUR_KERNEL_MAP[blur_kernel_size]) if blur_resample else _AvgPool(),
                nn.GroupNorm(32, cout, eps=1e-5),
                _Act()))
        self.blocks = nn.ModuleList(blocks)
        self.to_logits = nn.Sequential(nn.Conv2d(cout, cout, 1), _Act(),
                                       nn.Conv2d(cout, 1, 5, padding=2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images (b, H, W, C) -> NHWC logits (b, 16, 16, 1), in the
        compute dtype."""
        x = x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        x = self.act(conv(self.block_in[0], x))
        for block in self.blocks:
            x = block[1](conv(block[0], x))
            x = self.act(group_norm_f32(block[2], x))
        x = adaptive_max_pool_2d(x, (16, 16))
        x = self.act(conv(self.to_logits[0], x))
        return conv(self.to_logits[2], x).permute(0, 2, 3, 1)


class OriginalNLayerDiscriminator(nn.Module):
    def __init__(self, num_channels: int = 3, hidden_channels: int = 64, num_stages: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        layers = [nn.Conv2d(num_channels, hidden_channels, 4, stride=2, padding=1), _Act()]
        nf_mult = 1
        for n in range(1, num_stages + 1):
            nf_prev, nf_mult = nf_mult, min(2**n, 8)
            stride = 2 if n < num_stages else 1
            layers += [nn.Conv2d(hidden_channels * nf_prev, hidden_channels * nf_mult, 4,
                                 stride=stride, padding=1, bias=False),
                       nn.BatchNorm2d(hidden_channels * nf_mult, eps=1e-5), _Act()]
        layers.append(nn.Conv2d(hidden_channels * nf_mult, 1, 4, stride=1, padding=1))
        self.main = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> NHWC patch logits, in the compute dtype."""
        x = x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        for layer in self.main:
            if isinstance(layer, nn.Conv2d):
                x = conv(layer, x)
            elif isinstance(layer, nn.BatchNorm2d):
                x = F.batch_norm(x.float(), None, None, layer.weight.float(), layer.bias.float(),
                                 training=True, eps=layer.eps).to(x.dtype)
            else:
                x = F.leaky_relu(x, 0.2)
        return x.permute(0, 2, 3, 1)


def create_discriminator(cfg, dtype: torch.dtype = torch.float32) -> nn.Module:
    """From a `model.discriminator` config node: `Original` or
    `VQGAN+Discriminator` (the default)."""
    name = cfg.get("name", "VQGAN+Discriminator")
    if name == "Original":
        return OriginalNLayerDiscriminator(cfg.get("num_channels", 3),
                                           cfg.get("hidden_channels", 64),
                                           cfg.get("num_stages", 3), dtype=dtype)
    if name == "VQGAN+Discriminator":
        return NLayerDiscriminatorv2(cfg.get("num_channels", 3), cfg.get("hidden_channels", 64),
                                     cfg.get("num_stages", 3),
                                     blur_resample=cfg.get("blur_resample", False),
                                     blur_kernel_size=cfg.get("blur_kernel_size", 4), dtype=dtype)
    raise ValueError(f"Discriminator {name!r} is not implemented.")


def init_discriminator_weights_(disc: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisation: lecun-normal for the v2
    discriminator, N(0, 0.02^2) kernels for the Pix2Pix one."""
    std = 0.02 if isinstance(disc, OriginalNLayerDiscriminator) else 0.0
    init_flax_defaults_(disc, generator, conv_std=std)
