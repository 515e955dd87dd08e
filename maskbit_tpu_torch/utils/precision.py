"""Full float32 arithmetic inside a scope.

On a CUDA card cuDNN runs float32 convolutions in TF32 (a 10-bit mantissa)
unless told otherwise, and `torch.set_float32_matmul_precision` can send
cuBLAS float32 products there too. The evaluation networks and the VQ
nearest-code search keep float32 where the JAX package keeps it
(`Precision.HIGHEST`, float32 convolutions), so they run under `full_f32()`,
which switches TF32 off for both and puts the caller's flags back on exit.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
