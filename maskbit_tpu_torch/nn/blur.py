"""The discriminator's blur taps, numpy only.

`BLUR_KERNEL_MAP` and `blur_kernel` are shared by `nn/discriminator.py`
(the `BlurBlock` buffer) and `compat/torch_export.py` (which rebuilds that
buffer in exported state dicts), so that both hold one table and one
normalisation.
"""

from typing import Sequence

import numpy as np

BLUR_KERNEL_MAP = {3: (1, 2, 1), 4: (1, 3, 3, 1), 5: (1, 4, 6, 4, 1)}


def blur_kernel(taps: Sequence[int]) -> np.ndarray:
    """The normalised outer-product blur of `taps`, (1, 1, k, k) float32."""
    k1 = np.asarray(taps, np.float32)
    k2 = np.outer(k1, k1)
    return (k2 / k2.sum())[None, None].astype(np.float32)
