"""Exponential moving average of a model's parameters.

Counterpart of `maskbit_tpu/core/ema.py`: the same decay schedule
((1+s)/(10+s) or the power-law warmup), `update_after_step` gating,
`update_every` thinning and `min_decay` floor. The shadows are float32
tensors kept beside the model (a name -> tensor dict, as the JAX package
keeps a parameter tree) and updated in place. Under a sharded store
(`parallel/zero.py`) they shadow this rank's slices: `init_ema` and
`ema_update` take the store's `shards` in place of the model. `swapped_in`
lends them to the model (in-training generation samples with the EMA
weights); given the store it gathers them whole first (a collective).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Mapping, Union

import torch
from torch import nn


class EmaState:
    def __init__(self, params: Dict[str, torch.Tensor], step: int = 0):
        self.params = params  # name -> float32 shadow
        self.step = step


def _named(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def init_ema(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> EmaState:
    """float32 copies of a model's parameters, or of {name: slice} (never
    aliases)."""
    return EmaState({name: p.detach().float().clone() for name, p in _named(params).items()})


def ema_decay(optimization_step: int, decay: float = 0.9999, min_decay: float = 0.0,
              update_after_step: int = 0, use_ema_warmup: bool = False,
              inv_gamma: float = 1.0, power: float = 2.0 / 3.0) -> float:
    """Decay factor at a given step; 0 at step <= 0 (the first update copies)."""
    step = float(max(0, optimization_step - update_after_step - 1))
    if step <= 0:
        return 0.0
    if use_ema_warmup:
        value = 1.0 - (1.0 + step / inv_gamma) ** -power
    else:
        value = (1.0 + step) / (10.0 + step)
    return max(min(value, decay), min_decay)


@torch.no_grad()
def ema_update(state: EmaState, model: Union[nn.Module, Mapping[str, torch.Tensor]], decay: float = 0.9999,
               min_decay: float = 0.0, update_after_step: int = 0,
               use_ema_warmup: bool = False, inv_gamma: float = 1.0,
               power: float = 2.0 / 3.0, update_every: int = 1) -> EmaState:
    """One EMA step, in place: shadow <- shadow - (1 - d) * (shadow - param)."""
    state.step += 1
    if update_every > 1 and (state.step - 1) % update_every != 0:
        return state
    d = ema_decay(state.step, decay, min_decay, update_after_step, use_ema_warmup,
                  inv_gamma, power)
    names = list(state.params)
    params = _named(model)
    shadows = [state.params[n] for n in names]
    diffs = torch._foreach_sub(shadows, [params[n].float() for n in names])
    torch._foreach_mul_(diffs, 1.0 - d)
    torch._foreach_sub_(shadows, diffs)
    return state


@contextlib.contextmanager
def swapped_in(state: EmaState, model: nn.Module, store=None) -> Iterator[nn.Module]:
    """Inside the block the model's parameters hold the EMA shadows and
    `state.params` the trained weights: the tensors are exchanged, not
    copied, and exchanged back on exit. With a sharded store the shadows
    are gathered whole and lent to the model (`ShardedParams.whole_weights`,
    a collective)."""
    if store is not None and store.sharded:
        with store.whole_weights(state.params) as module:
            yield module
        return
    params = dict(model.named_parameters())

    def swap():
        for name, shadow in state.params.items():
            state.params[name] = params[name].data
            params[name].data = shadow

    swap()
    try:
        yield model
    finally:
        swap()
