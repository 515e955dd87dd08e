"""Image transforms for the input pipeline (PIL + numpy, on the host).

Counterpart of `maskbit_tpu/data/transforms.py`, with the same draws in the
same order, so the same image and seed give the same array:
  * train: RandomResizedCrop(resolution, scale=(min_scale, 1.0),
    ratio=(3/4, 4/3) when aspect-ratio augmentation is on) + horizontal flip;
  * eval: resize of the shorter side + center crop;
  * bilinear, bicubic, nearest or lanczos resampling.
Outputs are float32 HWC in [0, 1]. PIL is imported by the functions that
touch an image, so the package imports without it.
"""

from __future__ import annotations

import math
import random
from typing import Optional, Tuple

import numpy as np

INTERPOLATIONS = ("bilinear", "bicubic", "nearest", "lanczos")


def _pil_filter(name: str):
    from PIL import Image

    return {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC,
            "nearest": Image.NEAREST, "lanczos": Image.LANCZOS}[name]


def _check_interpolation(name: str) -> str:
    if name not in INTERPOLATIONS:
        raise KeyError(f"interpolation {name!r} is not one of {INTERPOLATIONS}")
    return name


def random_resized_crop_params(height: int, width: int, scale: Tuple[float, float],
                               ratio: Tuple[float, float], rng: random.Random
                               ) -> Tuple[int, int, int, int]:
    """(top, left, h, w) following torchvision RandomResizedCrop.get_params."""
    area = height * width
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect_ratio = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(math.sqrt(target_area * aspect_ratio)))
        h = int(round(math.sqrt(target_area / aspect_ratio)))
        if 0 < w <= width and 0 < h <= height:
            top = rng.randint(0, height - h)
            left = rng.randint(0, width - w)
            return top, left, h, w
    # fallback: center crop
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w = width
        h = int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h = height
        w = int(round(h * ratio[1]))
    else:
        w, h = width, height
    return (height - h) // 2, (width - w) // 2, h, w


class TrainTransform:
    """RandomResizedCrop + horizontal flip -> float32 HWC in [0, 1]."""

    def __init__(self, resolution: int = 256, min_scale: float = 0.8,
                 use_aspect_ratio_aug: bool = True, use_random_crop: bool = True,
                 interpolation: str = "bilinear", seed: Optional[int] = None):
        self.resolution = resolution
        self.min_scale = min_scale
        self.ratio = (3.0 / 4.0, 4.0 / 3.0) if use_aspect_ratio_aug else (1.0, 1.0)
        self.use_random_crop = use_random_crop
        self.interpolation = _check_interpolation(interpolation)
        self.rng = random.Random(seed)

    def __call__(self, img, rng: Optional[random.Random] = None) -> np.ndarray:
        """`rng` replaces the instance's: the reader passes one per sample,
        seeded by (seed, process, sample index), so the augmentation is a
        pure function of the sample's place in the stream."""
        from PIL import Image

        rng = self.rng if rng is None else rng
        interp = _pil_filter(self.interpolation)
        img = img.convert("RGB")
        if self.use_random_crop:
            top, left, h, w = random_resized_crop_params(
                img.height, img.width, (self.min_scale, 1.0), self.ratio, rng)
            img = img.resize((self.resolution, self.resolution), interp,
                             box=(left, top, left + w, top + h))
        else:
            img = center_crop(resize_shorter_side(img, self.resolution, interp), self.resolution)
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return np.asarray(img, np.float32) / 255.0


class EvalTransform:
    """Resize of the shorter side + center crop -> float32 HWC in [0, 1]."""

    def __init__(self, resolution: int = 256, interpolation: str = "bilinear"):
        self.resolution = resolution
        self.interpolation = _check_interpolation(interpolation)

    def __call__(self, img) -> np.ndarray:
        img = img.convert("RGB")
        img = resize_shorter_side(img, self.resolution, _pil_filter(self.interpolation))
        return np.asarray(center_crop(img, self.resolution), np.float32) / 255.0


def resize_shorter_side(img, size: int, interp):
    w, h = img.size
    if w <= h:
        new_w, new_h = size, max(size, int(round(size * h / w)))
    else:
        new_w, new_h = max(size, int(round(size * w / h))), size
    return img.resize((new_w, new_h), interp)


def center_crop(img, size: int):
    w, h = img.size
    left, top = (w - size) // 2, (h - size) // 2
    return img.crop((left, top, left + size, top + size))
