"""AdamW + global-norm clip (+ gradient accumulation) with optax's semantics.

Counterpart of `make_optimizer` in `maskbit_tpu/train/tokenizer_trainer.py`
(optax.chain(clip_by_global_norm, adamw), wrapped in optax.MultiSteps when
accumulating). Where optax and `torch.optim` differ, this follows optax:
  * the t-th update (0-based) uses `schedule(t)`: with warmup, the first
    update has learning rate 0;
  * decoupled weight decay applies to every parameter (no no-decay group):
    update = mhat / (sqrt(vhat) + eps) + wd * p, then p -= lr * update;
  * the clip is g * max_norm / g_norm only when g_norm >= max_norm (torch's
    `clip_grad_norm_` adds 1e-6 to the norm and always rescales);
  * with `gradient_accumulation_steps` k > 1, gradients are averaged over k
    micro-steps (optax.MultiSteps's running mean) and the clip and AdamW
    apply to the mean every k-th micro-step; the others leave the
    parameters unchanged.
Parameters and moments are float32; the update runs in place with
`torch._foreach_*` ops. The parameters may be slices of a sharded store
(`parallel/zero.py`): the update is elementwise, and `norm_fn` (the
store's `norm_fn`) gives the clip the norm over every rank's slices.
`state_dict` / `load_state_dict` carry the moments,
the accumulator and both counts (resume); `reset` is a fresh optimizer's
state (optax's `tx.init`).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, in float32 (optax.global_norm)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamW:
    def __init__(self, params, schedule: Callable[[int], float], beta1: float = 0.9,
                 beta2: float = 0.999, weight_decay: float = 1e-4, epsilon: float = 1e-8,
                 max_grad_norm: Optional[float] = 1.0, gradient_accumulation_steps: int = 1,
                 norm_fn: Optional[Callable[[List[torch.Tensor]], torch.Tensor]] = None):
        self.params = [p for p in params if p.requires_grad]
        self.norm_fn = global_norm if norm_fn is None else norm_fn
        if any(p.dtype != torch.float32 for p in self.params):
            raise TypeError("AdamW keeps float32 parameters (compute casts them on use)")
        self.schedule, self.b1, self.b2 = schedule, beta1, beta2
        self.weight_decay, self.eps = weight_decay, epsilon
        self.max_grad_norm = max_grad_norm if max_grad_norm and max_grad_norm > 0 else None
        self.k = max(1, int(gradient_accumulation_steps))
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.acc = ([torch.zeros_like(p, dtype=torch.float32) for p in self.params]
                    if self.k > 1 else None)
        self.count = 0  # updates applied (optax's adam and schedule count)
        self.mini_step = 0  # micro-steps since the last update (MultiSteps)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> bool:
        """Take one micro-step with `grads` (one per parameter, in order).
        Returns True when the parameters were updated."""
        grads = [g.float() for g in grads]
        if self.acc is not None:
            # running mean: acc + (g - acc) / (n + 1)
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, delta)
            self.mini_step += 1
            if self.mini_step < self.k:
                return False
            self.mini_step = 0
            grads = self.acc
        if self.max_grad_norm is not None:
            # optax: t if g_norm < max_norm else (t / g_norm) * max_norm
            g_norm = self.norm_fn(grads)
            clip = g_norm >= self.max_grad_norm
            div = torch.where(clip, g_norm, torch.ones_like(g_norm))
            mul = torch.where(clip, torch.full_like(g_norm, self.max_grad_norm),
                              torch.ones_like(g_norm))
            grads = [g / div * mul for g in grads]
        lr = float(self.schedule(self.count))
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, 1.0 - self.b2)
        bc1 = 1.0 - self.b1**self.count
        bc2 = 1.0 - self.b2**self.count
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, update, alpha=-lr)
        if self.acc is not None:
            for a in self.acc:
                a.zero_()
        return True

    def state_dict(self) -> dict:
        """The live moment tensors (in parameter order) and counts."""
        return {"mu": list(self.mu), "nu": list(self.nu),
                "acc": None if self.acc is None else list(self.acc),
                "count": self.count, "mini_step": self.mini_step}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a `state_dict` into this optimizer's tensors, in place."""
        if (state["acc"] is None) != (self.acc is None):
            raise ValueError("gradient accumulation differs from the saved optimizer's")
        for key in ("mu", "nu", "acc"):
            if state[key] is None:
                continue
            mine = getattr(self, key)
            if len(state[key]) != len(mine):
                raise ValueError(f"{key}: {len(state[key])} saved tensors for {len(mine)}")
            for dst, src in zip(mine, state[key]):
                dst.copy_(src)
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])

    @torch.no_grad()
    def reset(self) -> None:
        """Zero the moments, the accumulator and both counts."""
        for a in self.mu + self.nu + (self.acc or []):
            a.zero_()
        self.count = self.mini_step = 0


def make_optimizer(params, learning_rate_schedule, beta1: float = 0.9, beta2: float = 0.999,
                   weight_decay: float = 1e-4, epsilon: float = 1e-8,
                   max_grad_norm: Optional[float] = 1.0,
                   gradient_accumulation_steps: int = 1, norm_fn=None) -> AdamW:
    """Counterpart of `maskbit_tpu.train.tokenizer_trainer.make_optimizer`."""
    return AdamW(params, learning_rate_schedule, beta1, beta2, weight_decay, epsilon,
                 max_grad_norm, gradient_accumulation_steps, norm_fn)
