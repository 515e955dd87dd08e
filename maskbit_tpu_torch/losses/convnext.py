"""ConvNeXt-Small, the second backbone of the perceptual loss.

Counterpart of `maskbit_tpu/losses/convnext.py`, in torchvision's layout
and key names (`features.{i}...`, `classifier.{0,2}`), so torchvision's
`convnext_small` state dict loads strictly. NCHW input; returns (the last
stage's features, logits). Stated divergence: GELU is the exact erf one,
where the JAX package evaluates erf by a polynomial (|err| <= 1.5e-7).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from maskbit_tpu_torch.nn.conv import conv

DEPTHS = (3, 3, 27, 3)
DIMS = (96, 192, 384, 768)


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW tensor, in float32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.permute(0, 2, 3, 1).float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.permute(0, 3, 1, 2).to(x.dtype)


class _Slot(nn.Module):
    """A parameterless slot, so that indices match torchvision's."""


class CNBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv2d(dim, dim, 7, padding=3, groups=dim), _Slot(),
            nn.LayerNorm(dim, eps=1e-6), nn.Linear(dim, 4 * dim), _Slot(),
            nn.Linear(4 * dim, dim), _Slot())
        self.layer_scale = nn.Parameter(torch.full((dim, 1, 1), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dw, norm, pw1, pw2 = self.block[0], self.block[2], self.block[3], self.block[5]
        y = conv(dw, x).permute(0, 2, 3, 1)
        y = F.layer_norm(y.float(), norm.normalized_shape, norm.weight, norm.bias,
                         norm.eps).to(x.dtype)
        y = F.gelu(F.linear(y, pw1.weight.to(y.dtype), pw1.bias.to(y.dtype)))
        y = F.linear(y, pw2.weight.to(y.dtype), pw2.bias.to(y.dtype)).permute(0, 3, 1, 2)
        return x + y * self.layer_scale.to(y.dtype)


class ConvNeXtSmall(nn.Module):
    def __init__(self, num_classes: int = 1000):
        super().__init__()
        features = [nn.Sequential(nn.Conv2d(3, DIMS[0], 4, stride=4),
                                  LayerNorm2d(DIMS[0], eps=1e-6))]
        for stage, (depth, dim) in enumerate(zip(DEPTHS, DIMS)):
            if stage > 0:
                features.append(nn.Sequential(LayerNorm2d(DIMS[stage - 1], eps=1e-6),
                                              nn.Conv2d(DIMS[stage - 1], dim, 2, stride=2)))
            features.append(nn.Sequential(*(CNBlock(dim) for _ in range(depth))))
        self.features = nn.Sequential(*features)
        self.classifier = nn.Sequential(LayerNorm2d(DIMS[-1], eps=1e-6), nn.Flatten(1),
                                        nn.Linear(DIMS[-1], num_classes))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        for i, stage in enumerate(self.features):
            if i % 2 == 0:  # the stem and the downsamples: (norm, conv) or (conv, norm)
                first, second = stage
                x = second(conv(first, x)) if i == 0 else conv(second, first(x))
            else:
                x = stage(x)
        features = x
        pooled = self.classifier[0](x.mean(dim=(2, 3), keepdim=True)).flatten(1)
        fc = self.classifier[2]
        return features, F.linear(pooled, fc.weight.to(x.dtype), fc.bias.to(x.dtype))
