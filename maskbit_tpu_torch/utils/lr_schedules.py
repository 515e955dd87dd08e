"""Learning-rate schedules: step -> learning rate.

Counterpart of `maskbit_tpu/utils/lr_schedules.py` (constant,
constant_with_warmup, linear, cosine, cosine_with_minimum,
cosine_with_restarts, polynomial; all with linear warmup) and its
`get_schedule` factory. The step is a Python int and the rate a Python
float: the optimizer reads the rate on the host before each update.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

Schedule = Callable[[int], float]


def _warmup_factor(step: float, num_warmup_steps: int) -> float:
    return step / max(1.0, num_warmup_steps)


def constant_schedule(base_lr: float) -> Schedule:
    return lambda step: float(base_lr)


def constant_with_warmup_schedule(base_lr: float, num_warmup_steps: int) -> Schedule:
    def fn(step):
        step = float(step)
        return base_lr * (_warmup_factor(step, num_warmup_steps)
                          if step < num_warmup_steps else 1.0)

    return fn


def _with_warmup(base_lr: float, num_warmup_steps: int, decay_fn) -> Schedule:
    def fn(step):
        step = float(step)
        if step < num_warmup_steps:
            return base_lr * _warmup_factor(step, num_warmup_steps)
        return base_lr * decay_fn(step)

    return fn


def linear_schedule(base_lr: float, num_warmup_steps: int, num_training_steps: int) -> Schedule:
    span = max(1, num_training_steps - num_warmup_steps)
    return _with_warmup(base_lr, num_warmup_steps,
                        lambda step: max(0.0, (num_training_steps - step) / span))


def _progress(step: float, num_warmup_steps: int, num_training_steps: int) -> float:
    return (step - num_warmup_steps) / max(1, num_training_steps - num_warmup_steps)


def cosine_schedule(base_lr: float, num_warmup_steps: int, num_training_steps: int) -> Schedule:
    def decay(step):
        p = _progress(step, num_warmup_steps, num_training_steps)
        return max(0.0, 0.5 * (1.0 + math.cos(math.pi * p)))

    return _with_warmup(base_lr, num_warmup_steps, decay)


def cosine_with_minimum_schedule(base_lr: float, num_warmup_steps: int,
                                 num_training_steps: int, minimum_rate: float = 0.1) -> Schedule:
    """Cosine annealing to `minimum_rate * base_lr` instead of 0."""

    def decay(step):
        cos_term = 0.5 * (1.0 + math.cos(math.pi * _progress(step, num_warmup_steps,
                                                             num_training_steps)))
        return max(0.0, cos_term + minimum_rate - minimum_rate * cos_term)

    return _with_warmup(base_lr, num_warmup_steps, decay)


def cosine_with_restarts_schedule(base_lr: float, num_warmup_steps: int,
                                  num_training_steps: int, num_cycles: int = 1) -> Schedule:
    def decay(step):
        p = _progress(step, num_warmup_steps, num_training_steps)
        if p >= 1.0:
            return 0.0
        return max(0.0, 0.5 * (1.0 + math.cos(math.pi * ((num_cycles * p) % 1.0))))

    return _with_warmup(base_lr, num_warmup_steps, decay)


def polynomial_schedule(base_lr: float, num_warmup_steps: int, num_training_steps: int,
                        lr_end: float = 1e-7, power: float = 1.0) -> Schedule:
    if not base_lr > lr_end:
        raise ValueError(f"lr_end ({lr_end}) must be smaller than initial lr ({base_lr})")

    def decay(step):
        if step > num_training_steps:
            return lr_end / base_lr
        pct_remaining = 1.0 - (step - num_warmup_steps) / (num_training_steps - num_warmup_steps)
        return ((base_lr - lr_end) * pct_remaining**power + lr_end) / base_lr

    return _with_warmup(base_lr, num_warmup_steps, decay)


def get_schedule(name: str, base_lr: float, num_warmup_steps: Optional[int] = None,
                 num_training_steps: Optional[int] = None, num_cycles: int = 1,
                 power: float = 1.0, minimum_rate: float = 0.1) -> Schedule:
    """Factory over the config's `lr_scheduler.scheduler` name."""
    if name == "constant":
        return constant_schedule(base_lr)
    if num_warmup_steps is None:
        raise ValueError(f"{name} requires `num_warmup_steps`.")
    if name == "constant_with_warmup":
        return constant_with_warmup_schedule(base_lr, num_warmup_steps)
    if num_training_steps is None:
        raise ValueError(f"{name} requires `num_training_steps`.")
    if name == "linear":
        return linear_schedule(base_lr, num_warmup_steps, num_training_steps)
    if name == "cosine":
        return cosine_schedule(base_lr, num_warmup_steps, num_training_steps)
    if name == "cosine_with_minimum":
        return cosine_with_minimum_schedule(base_lr, num_warmup_steps, num_training_steps,
                                            minimum_rate)
    if name == "cosine_with_restarts":
        return cosine_with_restarts_schedule(base_lr, num_warmup_steps, num_training_steps,
                                             num_cycles)
    if name == "polynomial":
        return polynomial_schedule(base_lr, num_warmup_steps, num_training_steps, power=power)
    raise ValueError(f"Unknown scheduler {name!r}")
