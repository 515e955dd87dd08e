"""Visualisation helpers for training logs.

Counterpart of the Stage-II half of `maskbit_tpu/utils/viz.py` (the original
repo's utils/viz_utils.py): generated-sample grids and tokenizer
reconstruction | generator prediction pairs. Inputs are NHWC floats in
[0, 1]; each function returns (PIL images, uint8 grid array). PIL is
imported only to build the returned images.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _to_uint8(images: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(images), 0.0, 1.0) * 255.0).round().astype(np.uint8)


def _pil(arrays) -> list:
    from PIL import Image

    return [Image.fromarray(a) for a in arrays]


def make_viz_reconstructed_stage_two(reconstructed: np.ndarray, predicted: np.ndarray
                                     ) -> Tuple[List, np.ndarray]:
    """Per-sample [tokenizer reconstruction | generator prediction] pairs."""
    strips = [np.concatenate([_to_uint8(r), _to_uint8(p)], axis=1)
              for r, p in zip(np.asarray(reconstructed), np.asarray(predicted))]
    return _pil(strips), np.concatenate(strips, axis=0)


def make_viz_generated_stage_two(generated: np.ndarray, images_per_row: int = 4
                                 ) -> Tuple[List, np.ndarray]:
    """Grid of generated samples, `images_per_row` a row, the last row
    padded with black."""
    generated = _to_uint8(generated)
    b, h, w, c = generated.shape
    rows = []
    for start in range(0, b, images_per_row):
        row = list(generated[start:start + images_per_row])
        row += [np.zeros((h, w, c), np.uint8)] * (images_per_row - len(row))
        rows.append(np.concatenate(row, axis=1))
    return _pil(rows), np.concatenate(rows, axis=0)


def save_image_grid(grid: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray(grid).save(path)
