"""InceptionV3 feature extractor for FID and the Inception Score.

Counterpart of `maskbit_tpu/eval/inception.py`: the FID variant of
InceptionV3 (pt-fid / torch-fidelity), with the module names and parameter
shapes of torchvision's `inception_v3`, so the pt-fid `.pth` that
`MASKBIT_INCEPTION_WEIGHTS` names loads with `strict=True` and no
converter. Kept from the JAX package:
  * input: NHWC float RGB in [0, 255], any size; the TF1 bilinear resize to
    299x299 (`resize_bilinear_tf1`), then (x - 128) / 128;
  * BasicConv2d = conv (no bias) + frozen BatchNorm (eps 1e-3) + ReLU;
  * the FID blocks: 3x3 average pooling with `count_include_pad=False` in
    A, C and E_1, and a 3x3 max-pooling branch in E_2 (`Mixed_7c`);
  * two heads: '2048' (the global average pool) and 'logits_unbiased'
    (the pool times `fc.weight`, without the bias: 1008 classes).
The network runs in float32 with TF32 off inside its own forward
(`utils.precision.full_f32`), whatever the caller's global flags are:
cuDNN convolutions default to TF32.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from maskbit_tpu_torch.utils.precision import full_f32


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         training=False, eps=bn.eps)
        return F.relu(x)


def _avg_pool_nocountpad(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pooling, padding 1, the padding not counted."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_nocountpad(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        bp = self.branch_pool(_avg_pool_nocountpad(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool_mode: str):
        super().__init__()
        self.pool_mode = pool_mode  # "avg" (E_1) or "max" (E_2)
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        if self.pool_mode == "avg":
            bp = _avg_pool_nocountpad(x)
        else:
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], dim=1)


def _tf1_grid(in_size: int, out_size: int, device, dtype):
    """Source indices and weights of the TF1 legacy kernel on one axis:
    src = dst * float32(in/out), no half-pixel offset, floor and floor + 1
    clamped to the edge (numpy float32, as the JAX package computes them)."""
    scale = np.float32(in_size / out_size)
    src = np.arange(out_size, dtype=np.float32) * scale
    lo = np.minimum(np.floor(src), in_size - 1).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    t = src - lo.astype(np.float32)
    return (torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device),
            torch.from_numpy(t).to(device=device, dtype=dtype))


def resize_bilinear_tf1(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """TF1's legacy bilinear resize (align_corners=False, no half-pixel
    centres) of an NHWC float tensor, bit for bit the JAX package's: the
    lerp `a + (b - a) * t` as three separate eager ops (no `F.interpolate`,
    which samples at half-pixel centres and moves FID by tenths, and no
    `torch.lerp` or compiled code, which may reorder or fuse the arithmetic
    into an FMA), the width axis first, then the height."""
    _, in_h, in_w, _ = x.shape
    if (in_h, in_w) == (out_h, out_w):
        return x  # the TF1 kernel at scale 1 is the identity, bit for bit
    lo_x, hi_x, t_x = _tf1_grid(in_w, out_w, x.device, x.dtype)
    lo_y, hi_y, t_y = _tf1_grid(in_h, out_h, x.device, x.dtype)
    left, right = x.index_select(2, lo_x), x.index_select(2, hi_x)
    x = left + (right - left) * t_x[None, None, :, None]
    top, bottom = x.index_select(1, lo_y), x.index_select(1, hi_y)
    return top + (bottom - top) * t_y[None, :, None, None]


class InceptionV3(nn.Module):
    """FID InceptionV3: NHWC float RGB in [0, 255] of any size ->
    {'2048': (b, 2048), 'logits_unbiased': (b, 1008)}, float32."""

    def __init__(self, num_classes: int = 1008):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        # the pt-fid file holds fc.bias; 'logits_unbiased' does not use it
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        with full_f32():
            x = resize_bilinear_tf1(x.float(), 299, 299)
            x = ((x - 128.0) / 128.0).permute(0, 3, 1, 2)
            x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
            x = F.max_pool2d(x, 3, stride=2)
            x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
            x = F.max_pool2d(x, 3, stride=2)
            for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                          self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                          self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
                x = block(x)
            pooled = x.mean(dim=(2, 3))
            return {"2048": pooled, "logits_unbiased": pooled @ self.fc.weight.t()}


def load_inception_params(path: str) -> Dict[str, torch.Tensor]:
    """The pt-fid / torchvision `inception_v3` state dict in `path` (a
    `.pth`), on the CPU, for `InceptionV3.load_state_dict(strict=True)`."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in state.items() if not k.startswith("AuxLogits.")}


def inception_from_state(state: Mapping[str, torch.Tensor], device) -> InceptionV3:
    """An `InceptionV3` on `device` in eval mode with `state` loaded strictly."""
    with torch.device("meta"):
        model = InceptionV3()
    model = model.to_empty(device=device).eval()
    model.load_state_dict(state, strict=True)
    return model.requires_grad_(False)


def random_inception_state(seed: int) -> Dict[str, torch.Tensor]:
    """Seeded random weights in the pt-fid layout, for smoke runs and tests
    (no Inception weights ship with the repository): He-scaled kernels, so
    the features neither vanish nor blow up over the 94 units, BatchNorm
    means N(0, 0.05^2) and variances U(0.8, 1.2), `fc` N(0, 1/2048)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        shapes = {k: (v.shape, v.dtype) for k, v in InceptionV3().state_dict().items()}
    state = {}
    for key, (shape, dtype) in shapes.items():
        if key.endswith("num_batches_tracked"):
            state[key] = torch.zeros(shape, dtype=dtype)
        elif key.endswith("running_mean"):
            state[key] = torch.randn(shape, generator=gen) * 0.05
        elif key.endswith("running_var"):
            state[key] = 0.8 + 0.4 * torch.rand(shape, generator=gen)
        elif key.endswith("bn.weight"):
            state[key] = torch.ones(shape)
        elif key.endswith("bn.bias") or key == "fc.bias":
            state[key] = torch.zeros(shape)
        else:  # conv kernels and fc.weight
            fan_in = math.prod(shape[1:])
            gain = 2.0 if key.endswith("conv.weight") else 1.0
            state[key] = torch.randn(shape, generator=gen) * math.sqrt(gain / fan_in)
    return state
