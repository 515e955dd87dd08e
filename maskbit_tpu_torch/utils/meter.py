"""Running-average meter (counterpart of `maskbit_tpu/utils/meter.py`)."""

from __future__ import annotations


class AverageMeter:
    """The current value, the running sum, the count and the average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(1, self.count)
