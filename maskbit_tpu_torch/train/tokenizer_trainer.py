"""Stage-I (tokenizer) training step.

Counterpart of `maskbit_tpu/train/tokenizer_trainer.py`. One step, as one
Python function, computes what the JAX step computes:
  * the generator pass: the tokenizer's training forward, the
    discriminator's logits on the reconstructions with its *current*
    parameters (they take no gradient: the discriminator is out of autograd
    for this pass, and gradients reach the generator through it), and
    `losses.vqgan.generator_loss`; the perceptual loss is computed once and
    shared by the total and the adaptive weight;
  * the adaptive weight (`discriminator_gradient_penalty: adopt_weight`,
    only from `discriminator_start` on): the gradients of the nll loss and
    of the GAN loss with respect to `decoder.conv_out.weight`, by
    `torch.autograd.grad` on the step's graph as the original repo does.
    JAX decodes the detached latent again instead; the decoder sees z_q
    through the straight-through estimator, so the two are equal;
  * the global gradient norm, then clip + AdamW (`train/optim.py`) on the
    generator's trainable parameters: all of them, or only the decoder's
    in `finetune_decoder` mode (the JAX CLI masks its optimizer so);
  * the discriminator pass, from `discriminator_start` on: the
    pre-update discriminator on the images and the *detached*
    reconstructions of this step's generator pass (one concatenated pass
    for the v2 discriminator, whose GroupNorm is per sample; two for the
    Pix2Pix one, whose BatchNorm takes each batch's statistics), its loss
    with LeCam, and its own optimizer, which therefore counts only from the
    gate on; before the gate its metrics are zeros;
  * the EMA of the generator's parameters.
Parameters, moments and EMA shadows are updated in place. Stage I draws no
random numbers in the step.

Across processes (`parallel/mesh.py`, `parallel/zero.py`): the tokenizer
and the discriminator each have a `ShardedParams` store of this rank's
slices (parameters, AdamW moments and the tokenizer's EMA shadows; with
nothing split, the modules' own tensors). Each step gathers both modules'
whole parameters, runs on this rank's rows of the global batch, frees
each module's whole parameters once its gradients are taken, and
reduces the tokenizer's gradients, and from the gate on the
discriminator's, to the slices' gradients of the global batch's mean
before the grad norm (over every rank's slices) and the optimizers (a
frozen discriminator sends nothing). No tokenizer convolution is split
over `tensor` by the rules: the tensor axis only splits storage, and the
ranks of a tensor group step on the same rows. The entropy, LeCam and
adaptive-weight terms are the global batch's (`ops/entropy.py`,
`losses/vqgan.py`), and the metrics are averaged over the batch group, so
they are the global batch's too, and so are the Pix2Pix discriminator's
BatchNorm statistics (`nn/discriminator.batch_norm_over_group`). The
phases run inside
`torch.profiler.record_function` ranges ("tokenizer/generator",
"tokenizer/gather", "tokenizer/adaptive_weight", "tokenizer/backward",
"tokenizer/all_reduce", "tokenizer/optimizer",
"tokenizer/discriminator", "tokenizer/ema").
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import torch
from torch import nn
from torch.profiler import record_function

from maskbit_tpu_torch.core.ema import EmaState, ema_update, init_ema
from maskbit_tpu_torch.losses import gan
from maskbit_tpu_torch.losses.vqgan import (
    LecamState,
    VQGANLossConfig,
    calculate_adaptive_weight,
    discriminator_loss,
    generator_loss,
    nll_loss_only,
)
from maskbit_tpu_torch.nn.discriminator import NLayerDiscriminatorv2
from maskbit_tpu_torch.parallel.mesh import (
    batch_group,
    mean_across_processes,
    shard_train_state,
)
from maskbit_tpu_torch.parallel.zero import ShardedParams
from maskbit_tpu_torch.train.generator_trainer import (
    per_param_grad_norms,
    whole_opt_state,
)
from maskbit_tpu_torch.train.optim import AdamW


class TokenizerTrainState:
    """The tokenizer and discriminator (their parameters) and their
    stores, their two optimizers, the EMA shadows of the tokenizer, the
    LeCam state and the step."""

    def __init__(self, model: nn.Module, discriminator: nn.Module, gen_opt: AdamW,
                 disc_opt: AdamW, ema: Optional[EmaState], lecam: LecamState,
                 gen_store: ShardedParams, disc_store: ShardedParams):
        self.step = 0
        self.model, self.discriminator = model, discriminator
        self.gen_opt, self.disc_opt, self.ema, self.lecam = gen_opt, disc_opt, ema, lecam
        self.gen_store, self.disc_store = gen_store, disc_store

    def state_dict(self) -> dict:
        """The whole state (a collective; the live tensors when nothing is
        split)."""
        gs, ds = self.gen_store, self.disc_store
        return {"step": self.step,
                "gen_params": {n: t.detach() for n, t in gs.whole_params().items()},
                "disc_params": {n: t.detach() for n, t in ds.whole_params().items()},
                "gen_opt": whole_opt_state(gs, self.gen_opt),
                "disc_opt": whole_opt_state(ds, self.disc_opt),
                "ema": None if self.ema is None else {"params": gs.whole_dict(self.ema.params),
                                                      "step": self.ema.step},
                "lecam": dict(self.lecam._asdict())}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Copy a whole `state_dict` into this state's tensors (this rank's
        slices), in place."""
        for key, store in (("gen_params", self.gen_store), ("disc_params", self.disc_store)):
            try:
                store.load_whole_(state[key])
            except KeyError as e:
                raise KeyError(f"saved {key} differ: {e}") from None
        if (state["ema"] is None) != (self.ema is None):
            raise ValueError("the saved state and this one differ in having an EMA")
        for opt, store, key in ((self.gen_opt, self.gen_store, "gen_opt"),
                                (self.disc_opt, self.disc_store, "disc_opt")):
            opt.load_state_dict(shard_train_state(state[key], store.splits,
                                                  store.names_of(opt.params)))
        if self.ema is not None:
            sliced = shard_train_state(state["ema"]["params"], self.gen_store.splits)
            for name, shadow in sliced.items():
                self.ema.params[name].copy_(shadow)
            self.ema.step = int(state["ema"]["step"])
        for mine, saved in zip(self.lecam, (state["lecam"][k] for k in LecamState._fields)):
            mine.copy_(saved)
        self.step = int(state["step"])


def init_tokenizer_train_state(model: nn.Module, discriminator: nn.Module, gen_opt: AdamW,
                               disc_opt: AdamW, use_ema: bool = True,
                               gen_store: Optional[ShardedParams] = None,
                               disc_store: Optional[ShardedParams] = None) -> TokenizerTrainState:
    """The state over the stores' slices (each optimizer made from its
    store's `parameters()`), or, without stores, over the modules' own
    parameters."""
    device = next(model.parameters()).device
    gen_store = ShardedParams(model, replicate=True) if gen_store is None else gen_store
    disc_store = (ShardedParams(discriminator, replicate=True) if disc_store is None
                  else disc_store)
    return TokenizerTrainState(model, discriminator, gen_opt, disc_opt,
                               init_ema(gen_store.shards) if use_ema else None,
                               LecamState.init(device), gen_store, disc_store)


def make_tokenizer_train_step(model: nn.Module, discriminator: nn.Module,
                              loss_cfg: VQGANLossConfig,
                              perceptual_fn: Optional[Callable] = None,
                              ema_kwargs: Optional[Mapping[str, Any]] = None,
                              log_param_grad_norms: bool = False) -> Callable:
    """Build train_step(state, images) -> (state, metrics). Images are NHWC
    in [0, 1]; `perceptual_fn(a, b)` is the perceptual loss (a module such as
    `PerceptualLoss` or `LPIPS`, frozen) or None (zero)."""
    ema_kwargs = dict(ema_kwargs or {})
    use_adaptive = loss_cfg.discriminator_gradient_penalty == "adopt_weight"
    batch_disc_passes = isinstance(discriminator, NLayerDiscriminatorv2)

    def train_step(state: TokenizerTrainState, images: torch.Tensor):
        images = images.float()
        step = state.step
        disc_trainable = step >= loss_cfg.discriminator_start
        gen_store, disc_store = state.gen_store, state.disc_store
        gen_names = gen_store.names_of(state.gen_opt.params)
        disc_names = disc_store.names_of(state.disc_opt.params)
        gen_params = [gen_store.params[n] for n in gen_names]
        disc_params = [disc_store.params[n] for n in disc_names]
        with record_function("tokenizer/gather"):
            gen_store.gather()
            disc_store.gather()

        # ---- generator pass: D's current parameters, out of autograd ----
        discriminator.requires_grad_(False)
        with record_function("tokenizer/generator"):
            reconstructions, extra = model.train()(images, train=True)
            logits_fake = discriminator(reconstructions)
            if perceptual_fn is None:
                perceptual = images.new_zeros(())
            else:
                perceptual = torch.mean(perceptual_fn(images, reconstructions))
            cached = lambda a, b: perceptual  # noqa: E731 — one perceptual pass a step
        d_weight = 1.0
        if use_adaptive and disc_trainable:
            with record_function("tokenizer/adaptive_weight"):
                kernel = model.decoder.conv_out.weight
                nll = nll_loss_only(loss_cfg, images, reconstructions, cached)
                g = gan.G_LOSSES[loss_cfg.discriminator_loss](logits_fake.float())
                (nll_grads,) = torch.autograd.grad(nll, kernel, retain_graph=True)
                (g_grads,) = torch.autograd.grad(g, kernel, retain_graph=True)
                d_weight = calculate_adaptive_weight(nll_grads, g_grads)
        total, metrics = generator_loss(loss_cfg, images, reconstructions, extra, step, cached,
                                        logits_fake=logits_fake, d_weight=d_weight)
        with record_function("tokenizer/backward"):
            grads = list(torch.autograd.grad(total, gen_params, materialize_grads=True))
            gen_store.release()
        with record_function("tokenizer/all_reduce"):
            grads = gen_store.reduce_scatter_grads(gen_names, grads)
        with record_function("tokenizer/optimizer"):
            metrics["grad_norm"] = gen_store.global_norm(gen_names, grads)
            if log_param_grad_norms:
                metrics.update(per_param_grad_norms(gen_names, grads, gen_store))
            state.gen_opt.step(grads)
        del grads, logits_fake

        # ---- discriminator pass, from discriminator_start on -------------
        if disc_trainable:
            discriminator.requires_grad_(True)
            with record_function("tokenizer/discriminator"):
                fakes = reconstructions.detach()
                if batch_disc_passes:
                    both = discriminator(torch.cat([images, fakes.to(images.dtype)], dim=0))
                    logits_real, logits_fake = both.chunk(2, dim=0)
                else:
                    logits_real, logits_fake = discriminator(images), discriminator(fakes)
                d_loss, d_metrics, state.lecam = discriminator_loss(
                    loss_cfg, logits_real, logits_fake, step, state.lecam)
                d_grads = list(torch.autograd.grad(d_loss, disc_params, materialize_grads=True))
                state.disc_opt.step(disc_store.reduce_scatter_grads(disc_names, d_grads))
        else:
            zero = images.new_zeros(())
            d_metrics = {k: zero for k in ("discriminator_loss", "logits_real", "logits_fake",
                                           "lecam_loss")}
        discriminator.requires_grad_(True)  # as the step found it
        disc_store.release()

        if state.ema is not None:
            with record_function("tokenizer/ema"):
                ema_update(state.ema, gen_store.shards, **ema_kwargs)
        state.step += 1
        return state, mean_across_processes(
            {**metrics, **d_metrics, "train/total_loss": total.detach()}, batch_group())

    return train_step


def trainable_parameters(model: nn.Module, finetune_decoder: bool) -> list:
    """The parameters the generator's optimizer updates: the decoder's alone
    in `finetune_decoder` mode (the JAX CLI's `optax.masked`, which leaves
    the rest untouched, weight decay included), else all."""
    module = model.decoder if finetune_decoder else model
    return [p for p in module.parameters() if p.requires_grad]
