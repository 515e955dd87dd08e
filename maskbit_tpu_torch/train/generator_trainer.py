"""Stage-II (MaskBit generator) training step.

Counterpart of `maskbit_tpu/train/generator_trainer.py`
(`init_generator_train_state`, `make_generator_train_step` and its
`_mlm_step_core`). One step, as one Python function:
  * the frozen Stage-I tokenizer encodes the images inline (no grad);
  * the tokens are split into factorized tokens (codebook_splits);
  * the arccos schedule (or another) masks them;
  * class labels are dropped for CFG training;
  * the generator runs forward and backward (attention dropout through the
    dropout-attention kernels when the config sets `fused_attention_dropout`);
  * the MLM loss is label-smoothed cross entropy;
  * the global grad norm is taken, then clip + AdamW (`train/optim.py`);
  * the EMA is updated.
The parameters, optimizer moments and EMA shadows are updated in place.
The phases run inside `torch.profiler.record_function` ranges
("train/tokenize", "train/forward", "train/backward", "train/optimizer",
"train/ema") that `cli/profile_train.py` reads; outside a profiler they
cost a few microseconds a step.
Randomness comes from a `torch.Generator` passed to each step, or from
`injected` draws: "mask_ratio_uniform" (b,), "mask_token_uniform" (b, n, m),
"label_drop_uniform" (b,) and "attention_seeds", one (b, h) table per
attention layer call in order (tests hand both frameworks the same draws).
With `log_param_grad_norms` the metrics also hold each parameter's gradient
norm as "grad_norm/<parameter name>" (the JAX package names them by its
Flax paths).

Across processes (`parallel/mesh.py`, `parallel/zero.py`): the state's
`ShardedParams` store holds this rank's slices of the parameters, AdamW
moments and EMA shadows (with nothing split, the module's own tensors).
Each step gathers the whole parameters into the module ("train/gather"),
runs forward and backward on this rank's rows of the global batch (the
batch group's share: the ranks of one tensor group hold the same rows and
each runs its share of the heads and MLP columns), frees the whole
parameters again (`ShardedParams.release`), reduces the gradients
to the slices' gradients of the global batch ("train/all_reduce": a
reduce-scatter over fsdp and an all-reduce over data, or one all-reduce
over the batch group for a replicated parameter), takes the global norm
over every rank's slices, and updates the slices and their EMA. So every
process applies the global batch's update and the per-parameter norms are
the global gradient's. The metrics are the global batch's
(`losses/mlm.py`; the masked fraction averaged over the batch group).
Injected draws are given for the global batch and each process takes its
batch shard's rows (`local_rows`) and, for the attention seeds, its heads'
columns, so a run on any mesh draws the masks, label drops and attention
dropout masks of a one-process run; a `torch.Generator` is the caller's to
seed per batch shard (`parallel.mesh.rank_seed` over the batch group).
Under remat the recompute runs inside `torch.autograd.grad`, so the
gradients are reduced once, after it. `state_dict()` gathers the whole
state (a collective) and `load_state_dict` keeps this rank's slices, so a
checkpoint does not depend on the mesh.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from maskbit_tpu_torch.core.ema import EmaState, ema_update, init_ema
from maskbit_tpu_torch.losses.mlm import MLMLossConfig, mlm_loss
from maskbit_tpu_torch.nn.transformer import DropoutRng
from maskbit_tpu_torch.ops.bitops import split_factorized_tokens
from maskbit_tpu_torch.ops.masking import get_mask_tokens
from maskbit_tpu_torch.parallel.mesh import batch_group, global_mean, local_rows, shard_train_state
from maskbit_tpu_torch.parallel.zero import ShardedParams
from maskbit_tpu_torch.train.optim import AdamW


def whole_opt_state(store: ShardedParams, opt: AdamW) -> dict:
    """The optimizer's `state_dict` with its moments whole (a collective)."""
    sd = opt.state_dict()
    names = store.names_of(opt.params)
    for key in ("mu", "nu", "acc"):
        if sd[key] is not None:
            sd[key] = store.whole(names, sd[key])
    return sd


class GeneratorTrainState:
    """The model (its parameters), their store, the optimizer and the EMA
    shadows."""

    def __init__(self, model: nn.Module, opt: AdamW, ema: Optional[EmaState],
                 store: ShardedParams):
        self.step = 0
        self.model, self.opt, self.ema, self.store = model, opt, ema, store

    def state_dict(self) -> dict:
        """The whole state: step, parameters by name, the optimizer's
        `state_dict`, the EMA shadows and step (a collective; the live
        tensors when nothing is split)."""
        store = self.store
        return {"step": self.step,
                "params": {n: t.detach() for n, t in store.whole_params().items()},
                "opt": whole_opt_state(store, self.opt),
                "ema": None if self.ema is None else {"params": store.whole_dict(self.ema.params),
                                                      "step": self.ema.step}}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Copy a whole `state_dict` into this state's tensors (this rank's
        slices), in place."""
        if (state["ema"] is None) != (self.ema is None):
            raise ValueError("the saved state and this one differ in having an EMA")
        store = self.store
        store.load_whole_(state["params"])
        self.opt.load_state_dict(shard_train_state(state["opt"], store.splits,
                                                    store.names_of(self.opt.params)))
        if self.ema is not None:
            for name, shadow in shard_train_state(state["ema"]["params"], store.splits).items():
                self.ema.params[name].copy_(shadow)
            self.ema.step = int(state["ema"]["step"])
        self.step = int(state["step"])


def init_generator_train_state(model: nn.Module, opt: AdamW, use_ema: bool = True,
                               store: Optional[ShardedParams] = None) -> GeneratorTrainState:
    """The state of `model` and `opt`: over `store`'s slices (the
    optimizer made from `store.parameters()`), or, without a store, over
    the module's own parameters."""
    store = ShardedParams(model, replicate=True) if store is None else store
    return GeneratorTrainState(model, opt, init_ema(store.shards) if use_ema else None, store)


def per_param_grad_norms(names, grads, store: Optional[ShardedParams] = None
                         ) -> Dict[str, torch.Tensor]:
    """{"grad_norm/<name>": float32 L2 norm} for the original repo's
    periodic per-parameter dump; of slices' gradients over every rank with
    a sharded store (a collective)."""
    if store is not None and store.sharded:
        norms = store.squared_norms(names, grads).sqrt().unbind()
    else:
        norms = torch._foreach_norm([g.float() for g in grads])
    return {f"grad_norm/{name}": n for name, n in zip(names, norms)}


def local_injected(injected: Mapping[str, Any], b_local: int) -> Dict[str, Any]:
    """This batch shard's rows of draws given for the global batch: the
    (b,) and (b, n, m) uniforms and each (b, h) attention seed table."""
    def rows(x):
        return local_rows(x if torch.is_tensor(x) else np.asarray(x), b_local, batch_group())

    out = {k: rows(v) for k, v in injected.items() if k != "attention_seeds"}
    if "attention_seeds" in injected:
        out["attention_seeds"] = [rows(t) for t in injected["attention_seeds"]]
    return out


def _mlm_step_core(model, mlm_cfg: MLMLossConfig, codebook_size: int, mask_schedule: str,
                   class_label_dropout: float, ema_kwargs: Mapping[str, Any],
                   log_param_grad_norms: bool) -> Callable:
    """The MLM update given raw (b, n) integer tokens."""
    splits, mask_token = model.codebook_splits, model.mask_token

    def update(state: GeneratorTrainState, tokens: torch.Tensor, labels: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               injected: Optional[Mapping[str, Any]] = None):
        b, dev = tokens.shape[0], tokens.device
        if injected is not None:
            injected = local_injected(injected, b)
        split_tokens = split_factorized_tokens(tokens, codebook_size, splits)
        masked_tokens, masks = get_mask_tokens(split_tokens, mask_token, mode=mask_schedule,
                                               generator=generator, injected=injected)
        if injected is not None:
            u = torch.as_tensor(injected["label_drop_uniform"], dtype=torch.float32, device=dev)
        else:
            u = torch.rand((b,), generator=generator, device=dev)
        drop_label_mask = u < class_label_dropout
        rng = DropoutRng(generator, None if injected is None else injected["attention_seeds"])

        model, store = state.model.train(), state.store
        names = store.names_of(state.opt.params)
        with record_function("train/gather"):
            store.gather()
        with record_function("train/forward"):
            logits = model(masked_tokens, labels, drop_label_mask, rng)
            loss, loss_dict = mlm_loss(logits, split_tokens, masks, mlm_cfg)
        with record_function("train/backward"):
            grads = list(torch.autograd.grad(loss, [store.params[n] for n in names]))
            store.release()
        with record_function("train/all_reduce"):
            grads = store.reduce_scatter_grads(names, grads)
        with record_function("train/optimizer"):
            grad_norm = store.global_norm(names, grads)
            state.opt.step(grads)
        if state.ema is not None:
            with record_function("train/ema"):
                ema_update(state.ema, store.shards, **ema_kwargs)
        state.step += 1

        metrics: Dict[str, torch.Tensor] = {k: v.detach() for k, v in loss_dict.items()}
        metrics["grad_norm"] = grad_norm
        metrics["train/masked_fraction"] = global_mean(masks.float().mean(), batch_group())
        if log_param_grad_norms:
            metrics.update(per_param_grad_norms(names, grads, store))
        # non-scalar viz payloads (underscore keys; the CLI pops them)
        metrics["_input_tokens"] = split_tokens
        metrics["_predicted_tokens"] = logits.detach().argmax(-1)
        return state, metrics

    return update


def make_generator_train_step(model, tokenizer, mlm_cfg: MLMLossConfig,
                              mask_schedule: str = "arccos", class_label_dropout: float = 0.1,
                              ema_kwargs: Optional[Mapping[str, Any]] = None,
                              log_param_grad_norms: bool = False) -> Callable:
    """Build train_step(state, images, labels, generator=None, injected=None)
    -> (state, metrics). Images NHWC in [0, 1]; the frozen tokenizer runs
    under no_grad inside the step."""
    update = _mlm_step_core(model, mlm_cfg, tokenizer.codebook_size, mask_schedule,
                            class_label_dropout, dict(ema_kwargs or {}), log_param_grad_norms)

    def train_step(state, images, labels, generator=None, injected=None):
        with torch.no_grad(), record_function("train/tokenize"):
            tokens = tokenizer.eval().tokenize(images).reshape(images.shape[0], -1)
        return update(state, tokens, labels, generator, injected)

    return train_step


def make_generator_train_step_from_tokens(model, codebook_size: int, mlm_cfg: MLMLossConfig,
                                          mask_schedule: str = "arccos",
                                          class_label_dropout: float = 0.1,
                                          ema_kwargs: Optional[Mapping[str, Any]] = None,
                                          log_param_grad_norms: bool = False) -> Callable:
    """Build train_step(state, tokens (b, n), labels, generator=None,
    injected=None): the same update without the tokenizer."""
    return _mlm_step_core(model, mlm_cfg, codebook_size, mask_schedule, class_label_dropout,
                          dict(ema_kwargs or {}), log_param_grad_norms)
