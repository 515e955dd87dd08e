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

Data parallelism (`parallel/mesh.py`): each process steps on its share of
the global batch, and its gradients are averaged over the processes
(`all_reduce_mean_`, in the "train/all_reduce" range) before the grad norm
and the optimizer, so every process applies the global batch's update and
the per-parameter norms are the global gradient's. The metrics are the
global batch's (`losses/mlm.py`; the masked fraction averaged). Injected
draws are given for the global batch and each process takes its rows
(`local_rows`), so a run over N processes draws the masks, label drops and
attention dropout masks of a one-process run row for row; a
`torch.Generator` is the caller's to seed per process
(`parallel.mesh.rank_seed`). Under remat the recompute runs inside
`torch.autograd.grad`, so the gradients are reduced once, after it.
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
from maskbit_tpu_torch.parallel.mesh import all_reduce_mean_, global_mean, local_rows
from maskbit_tpu_torch.train.optim import AdamW, global_norm


class GeneratorTrainState:
    """The model (its parameters), the optimizer and the EMA shadows."""

    def __init__(self, model: nn.Module, opt: AdamW, ema: Optional[EmaState]):
        self.step = 0
        self.model, self.opt, self.ema = model, opt, ema

    def state_dict(self) -> dict:
        """The live tensors and counts of the state: step, parameters by
        name, the optimizer's `state_dict`, the EMA shadows and step."""
        return {"step": self.step,
                "params": {n: p.detach() for n, p in self.model.named_parameters()},
                "opt": self.opt.state_dict(),
                "ema": None if self.ema is None else {"params": dict(self.ema.params),
                                                      "step": self.ema.step}}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Copy a `state_dict` into this state's tensors, in place."""
        params = dict(self.model.named_parameters())
        if set(state["params"]) != set(params):
            raise KeyError(f"saved parameters differ: {sorted(set(state['params']) ^ set(params))[:5]}")
        if (state["ema"] is None) != (self.ema is None):
            raise ValueError("the saved state and this one differ in having an EMA")
        for name, p in params.items():
            p.copy_(state["params"][name])
        self.opt.load_state_dict(state["opt"])
        if self.ema is not None:
            for name, shadow in self.ema.params.items():
                shadow.copy_(state["ema"]["params"][name])
            self.ema.step = int(state["ema"]["step"])
        self.step = int(state["step"])


def init_generator_train_state(model: nn.Module, opt: AdamW,
                               use_ema: bool = True) -> GeneratorTrainState:
    return GeneratorTrainState(model, opt, init_ema(model) if use_ema else None)


def per_param_grad_norms(names, grads) -> Dict[str, torch.Tensor]:
    """{"grad_norm/<name>": float32 L2 norm} for the original repo's
    periodic per-parameter dump."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return {f"grad_norm/{name}": n for name, n in zip(names, norms)}


def local_injected(injected: Mapping[str, Any], b_local: int) -> Dict[str, Any]:
    """This process's rows of draws given for the global batch: the (b,)
    and (b, n, m) uniforms and each (b, h) attention seed table."""
    def rows(x):
        return local_rows(x if torch.is_tensor(x) else np.asarray(x), b_local)

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

        model = state.model.train()
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        params = [p for _, p in named]
        with record_function("train/forward"):
            logits = model(masked_tokens, labels, drop_label_mask, rng)
            loss, loss_dict = mlm_loss(logits, split_tokens, masks, mlm_cfg)
        with record_function("train/backward"):
            grads = list(torch.autograd.grad(loss, params))
        with record_function("train/all_reduce"):
            all_reduce_mean_(grads)
        with record_function("train/optimizer"):
            grad_norm = global_norm(grads)
            state.opt.step(grads)
        if state.ema is not None:
            with record_function("train/ema"):
                ema_update(state.ema, model, **ema_kwargs)
        state.step += 1

        metrics: Dict[str, torch.Tensor] = {k: v.detach() for k, v in loss_dict.items()}
        metrics["grad_norm"] = grad_norm
        metrics["train/masked_fraction"] = global_mean(masks.float().mean())
        if log_param_grad_norms:
            metrics.update(per_param_grad_norms([n for n, _ in named], grads))
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
