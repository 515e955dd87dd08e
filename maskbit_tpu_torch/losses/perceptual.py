"""Perceptual loss on a frozen ImageNet classifier's logits or features.

Counterpart of `maskbit_tpu/losses/perceptual.py`: both images (NHWC in
[0, 1]) are resized to 224x224 bilinearly with antialiasing
(`resize_224_bilinear`; `jax.image.resize`'s "bilinear" antialiases when it
downscales, as `F.interpolate(..., antialias=True)` does), normalised with
the ImageNet mean and std and put through a frozen backbone; the loss is
the MSE between the logits (`compute_on_logits`, the default) or the MSE
of the last features plus that of the logits. The backbones keep
torchvision's layout and key names, so torchvision's `resnet50` and
`convnext_small` state dicts load strictly: `ResNet50` here (its BatchNorm
frozen, `FrozenBatchNorm`, the running statistics applied in float32) and
`losses/convnext.ConvNeXtSmall`. The backbone's parameters take no
gradient; the images do. Like the JAX package's, the loss computes in
float32 whatever the trainer's dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from maskbit_tpu_torch.nn.conv import conv

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class FrozenBatchNorm(nn.BatchNorm2d):
    """Inference BatchNorm from the stored running statistics, in float32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight,
                            self.bias, training=False, eps=self.eps)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, filters, 1, bias=False)
        self.bn1 = FrozenBatchNorm(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(filters)
        self.conv3 = nn.Conv2d(filters, filters * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(filters * 4)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, filters * 4, 1, stride=stride, bias=False),
                                         FrozenBatchNorm(filters * 4)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        y = F.relu(self.bn1(conv(self.conv1, x)).to(dtype))
        y = F.relu(self.bn2(conv(self.conv2, y)).to(dtype))
        y = self.bn3(conv(self.conv3, y)).to(dtype)
        residual = x
        if self.downsample is not None:
            residual = self.downsample[1](conv(self.downsample[0], x)).to(dtype)
        return F.relu(y + residual)


class ResNet50(nn.Module):
    """torchvision-layout ResNet-50 on NCHW input: (layer4 features, logits)."""

    def __init__(self, num_classes: int = 1000):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        cin = 64
        for stage, num_blocks in enumerate((3, 4, 6, 3)):
            filters = 64 * 2**stage
            blocks = []
            for block in range(num_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                blocks.append(Bottleneck(cin, filters, stride, downsample=block == 0))
                cin = filters * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.bn1(conv(self.conv1, x)).to(x.dtype))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
        pooled = x.mean(dim=(2, 3))
        return x, F.linear(pooled, self.fc.weight.to(x.dtype), self.fc.bias.to(x.dtype))


def resize_224_bilinear(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> (b, c, 224, 224) float32, bilinear with antialiasing."""
    return F.interpolate(x.float(), size=(224, 224), mode="bilinear", align_corners=False,
                         antialias=True)


def make_backbone(model_name: str) -> nn.Module:
    if model_name == "resnet50":
        return ResNet50()
    if model_name == "convnext_s":
        from maskbit_tpu_torch.losses.convnext import ConvNeXtSmall

        return ConvNeXtSmall()
    raise NotImplementedError(
        f"Perceptual backbone {model_name!r} not implemented; use 'resnet50' or 'convnext_s'.")


class PerceptualLoss(nn.Module):
    """MSE between frozen-classifier outputs of two NHWC image batches in
    [0, 1]; the backbone's state dict is `model.*` (torchvision's keys)."""

    def __init__(self, model_name: str = "resnet50", compute_on_logits: bool = True):
        super().__init__()
        self.compute_on_logits = compute_on_logits
        self.model = make_backbone(model_name)
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD).view(1, 3, 1, 1),
                             persistent=False)
        self.requires_grad_(False)

    def reset_buffers(self) -> None:
        self.mean.copy_(torch.tensor(_IMAGENET_MEAN).view(1, 3, 1, 1))
        self.std.copy_(torch.tensor(_IMAGENET_STD).view(1, 3, 1, 1))

    def _prep(self, x: torch.Tensor) -> torch.Tensor:
        x = resize_224_bilinear(x.permute(0, 3, 1, 2))
        return ((x - self.mean) / self.std).contiguous(memory_format=torch.channels_last)

    def forward(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        feat_in, logit_in = self.model(self._prep(input))
        feat_tg, logit_tg = self.model(self._prep(target))
        loss = torch.mean((logit_in.float() - logit_tg.float()) ** 2)
        if not self.compute_on_logits:
            loss = torch.mean((feat_in.float() - feat_tg.float()) ** 2) + loss
        return loss
