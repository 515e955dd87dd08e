"""LPIPS: VGG16 features and five learned 1x1 heads.

Counterpart of `maskbit_tpu/losses/lpips.py`: both images (NHWC in [0, 1])
go to [-1, 1] and through the LPIPS scaling layer (shift, scale), then
VGG16's conv trunk; at relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3 the
features are unit-normalised over channels (eps 1e-10), their squared
difference weighted by the 1x1 head `lin{k}` (no bias) and averaged over
space; the five are summed: (b, 1, 1, 1). Key names are the original
repo's: `net.slice{1..5}.{i}` (VGG16's `features.{i}`), `lin{k}.model.1`,
`scaling_layer.shift|scale`. The lin heads ship with the port as
`assets/vgg_lpips_lin.msgpack` (the JAX package's file, read by
`compat/msgpack`); the VGG16 trunk comes from torchvision's `vgg16` state
dict (`load_lpips`).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from maskbit_tpu_torch.nn.conv import conv

_VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
# torchvision `features` index where each LPIPS slice ends (exclusive)
_SLICE_ENDS = (4, 9, 16, 23, 30)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def bundled_lin_weights_path() -> str:
    """The lin heads shipped with the port (a byte-equal copy of the JAX
    package's `assets/vgg_lpips_lin.msgpack`)."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "assets", "vgg_lpips_lin.msgpack")


class ScalingLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))

    def reset_buffers(self) -> None:
        self.shift.copy_(torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.scale.copy_(torch.tensor(_SCALE).view(1, 3, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x * 2.0 - 1.0 - self.shift) / self.scale


class VGG16Features(nn.Module):
    """VGG16's conv trunk as the five LPIPS slices (`slice{k}.{i}` keeps
    torchvision's index i)."""

    def __init__(self):
        super().__init__()
        layers: List[nn.Module] = []
        cin = 3
        for item in _VGG16_CFG:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, item, 3, padding=1), nn.ReLU()]
                cin = item
        start = 0
        for k, end in enumerate(_SLICE_ENDS):
            piece = nn.Sequential()
            for i in range(start, end):
                piece.add_module(str(i), layers[i])
            setattr(self, f"slice{k + 1}", piece)
            start = end

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outputs = []
        for k in range(1, 6):
            for layer in getattr(self, f"slice{k}"):
                x = conv(layer, x) if isinstance(layer, nn.Conv2d) else layer(x)
            outputs.append(x)
        return outputs


class NetLinLayer(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(channels, 1, 1, bias=False))


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt((x.float() ** 2).sum(dim=1, keepdim=True))
    return (x / (norm + eps)).to(x.dtype)


class LPIPS(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scaling_layer = ScalingLayer()
        self.net = VGG16Features()
        for k, channels in enumerate(LPIPS_CHANNELS):
            setattr(self, f"lin{k}", NetLinLayer(channels))
        self.requires_grad_(False)

    def forward(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """NHWC images in [0, 1] -> per-image distances (b, 1, 1, 1), float32."""
        def features(x):
            x = self.scaling_layer(x.permute(0, 3, 1, 2).float())
            return self.net(x.to(self.dtype, memory_format=torch.channels_last))

        val = 0.0
        for k, (f0, f1) in enumerate(zip(features(input), features(target))):
            diff = ((_unit_normalize(f0) - _unit_normalize(f1)) ** 2).float()
            lin = F.conv2d(diff, getattr(self, f"lin{k}").model[1].weight.float())
            val = val + lin.mean(dim=(2, 3), keepdim=True)
        return val.permute(0, 2, 3, 1)


def lin_state_from_flax(tree: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's lin-head tree ({"lin_k": {"kernel": (1, 1, C, 1)}})
    -> `lin{k}.model.1.weight` (1, C, 1, 1)."""
    return {f"lin{k}.model.1.weight": torch.from_numpy(
                np.array(np.asarray(tree[f"lin_{k}"]["kernel"]).transpose(3, 2, 0, 1)))
            for k in range(len(LPIPS_CHANNELS))}


def vgg16_state_to_lpips(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision `vgg16` (`features.{i}.*`; `classifier.*` dropped) ->
    `net.slice{k}.{i}.*`."""
    out = {}
    for key, value in state.items():
        parts = key.split(".")
        if parts[0] != "features":
            continue
        i = int(parts[1])
        k = next(n for n, end in enumerate(_SLICE_ENDS) if i < end) + 1
        out[f"net.slice{k}.{i}.{parts[2]}"] = value
    return out


def load_lpips(lin_path: str, vgg_path: str, device="cpu") -> LPIPS:
    """LPIPS with the lin heads of `lin_path` (a flax `.msgpack`, or the
    original repo's `vgg_lpips.pth`) and torchvision's VGG16 at `vgg_path`,
    loaded strictly, in eval mode on `device`."""
    from maskbit_tpu_torch.compat.msgpack import read_msgpack

    model = LPIPS()
    if lin_path.endswith(".msgpack"):
        lin = lin_state_from_flax(read_msgpack(lin_path))
    else:
        lin = {k: v for k, v in torch.load(lin_path, map_location="cpu",
                                           weights_only=True).items() if k.startswith("lin")}
    state = dict(lin, **vgg16_state_to_lpips(
        torch.load(vgg_path, map_location="cpu", weights_only=True)))
    state.update({f"scaling_layer.{k}": v for k, v in model.scaling_layer.state_dict().items()})
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()


def random_vgg16_state(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A torchvision-layout `vgg16` features state dict of seeded random
    weights (He-normal kernels, zero biases), for smoke runs and tests."""
    gen = torch.Generator().manual_seed(seed)
    state, cin, i = {}, 3, 0
    for item in _VGG16_CFG:
        if item == "M":
            i += 1
            continue
        state[f"features.{i}.weight"] = torch.randn(item, cin, 3, 3, generator=gen) * (
            2.0 / (cin * 9)) ** 0.5
        state[f"features.{i}.bias"] = torch.zeros(item)
        cin, i = item, i + 2
    return state


def lpips_weights() -> Tuple[str, str, List[str]]:
    """(lin-head path, VGG16 path, the missing ones as "VAR='path'"): the
    lin heads from `MASKBIT_LPIPS_WEIGHTS` (default: the shipped
    `.msgpack`), VGG16 from `MASKBIT_VGG16_WEIGHTS`."""
    lin_path = os.environ.get("MASKBIT_LPIPS_WEIGHTS", bundled_lin_weights_path())
    vgg_path = os.environ.get("MASKBIT_VGG16_WEIGHTS", "")
    missing = [f"{var}={path!r}" for var, path in (("MASKBIT_LPIPS_WEIGHTS", lin_path),
                                                    ("MASKBIT_VGG16_WEIGHTS", vgg_path))
               if not os.path.exists(path)]
    return lin_path, vgg_path, missing
