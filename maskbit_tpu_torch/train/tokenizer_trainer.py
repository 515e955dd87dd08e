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

Data parallelism (`parallel/mesh.py`): each process steps on its share of
the global batch; the tokenizer's gradients, and from the gate on the
discriminator's, are averaged over the processes before the grad norm and
the optimizers (a frozen discriminator sends nothing), so every process
holds the same parameters; the entropy, LeCam and adaptive-weight terms are
the global batch's (`ops/entropy.py`, `losses/vqgan.py`), and the metrics
are averaged over the processes, so they are the global batch's too. The
Pix2Pix discriminator's BatchNorm would need the global batch's statistics:
it is refused across processes. The phases run inside
`torch.profiler.record_function` ranges ("tokenizer/generator",
"tokenizer/adaptive_weight", "tokenizer/backward", "tokenizer/optimizer",
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
from maskbit_tpu_torch.nn.discriminator import NLayerDiscriminatorv2, OriginalNLayerDiscriminator
from maskbit_tpu_torch.parallel.mesh import all_reduce_mean_, mean_across_processes, process_count
from maskbit_tpu_torch.train.generator_trainer import per_param_grad_norms
from maskbit_tpu_torch.train.optim import AdamW, global_norm


class TokenizerTrainState:
    """The tokenizer and discriminator (their parameters), their two
    optimizers, the EMA shadows of the tokenizer, the LeCam state and the
    step."""

    def __init__(self, model: nn.Module, discriminator: nn.Module, gen_opt: AdamW,
                 disc_opt: AdamW, ema: Optional[EmaState], lecam: LecamState):
        self.step = 0
        self.model, self.discriminator = model, discriminator
        self.gen_opt, self.disc_opt, self.ema, self.lecam = gen_opt, disc_opt, ema, lecam

    def state_dict(self) -> dict:
        """The live tensors and counts of the state."""
        return {"step": self.step,
                "gen_params": {n: p.detach() for n, p in self.model.named_parameters()},
                "disc_params": {n: p.detach() for n, p in self.discriminator.named_parameters()},
                "gen_opt": self.gen_opt.state_dict(), "disc_opt": self.disc_opt.state_dict(),
                "ema": None if self.ema is None else {"params": dict(self.ema.params),
                                                      "step": self.ema.step},
                "lecam": dict(self.lecam._asdict())}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Copy a `state_dict` into this state's tensors, in place."""
        for key, module in (("gen_params", self.model), ("disc_params", self.discriminator)):
            params = dict(module.named_parameters())
            if set(state[key]) != set(params):
                raise KeyError(f"saved {key} differ: "
                               f"{sorted(set(state[key]) ^ set(params))[:5]}")
            for name, p in params.items():
                p.copy_(state[key][name])
        if (state["ema"] is None) != (self.ema is None):
            raise ValueError("the saved state and this one differ in having an EMA")
        self.gen_opt.load_state_dict(state["gen_opt"])
        self.disc_opt.load_state_dict(state["disc_opt"])
        if self.ema is not None:
            for name, shadow in self.ema.params.items():
                shadow.copy_(state["ema"]["params"][name])
            self.ema.step = int(state["ema"]["step"])
        for mine, saved in zip(self.lecam, (state["lecam"][k] for k in LecamState._fields)):
            mine.copy_(saved)
        self.step = int(state["step"])


def init_tokenizer_train_state(model: nn.Module, discriminator: nn.Module, gen_opt: AdamW,
                               disc_opt: AdamW, use_ema: bool = True) -> TokenizerTrainState:
    device = next(model.parameters()).device
    return TokenizerTrainState(model, discriminator, gen_opt, disc_opt,
                               init_ema(model) if use_ema else None, LecamState.init(device))


def make_tokenizer_train_step(model: nn.Module, discriminator: nn.Module,
                              loss_cfg: VQGANLossConfig,
                              perceptual_fn: Optional[Callable] = None,
                              ema_kwargs: Optional[Mapping[str, Any]] = None,
                              log_param_grad_norms: bool = False) -> Callable:
    """Build train_step(state, images) -> (state, metrics). Images are NHWC
    in [0, 1]; `perceptual_fn(a, b)` is the perceptual loss (a module such as
    `PerceptualLoss` or `LPIPS`, frozen) or None (zero)."""
    if isinstance(discriminator, OriginalNLayerDiscriminator) and process_count() > 1:
        raise NotImplementedError(
            "the Pix2Pix discriminator's BatchNorm takes the global batch's statistics under "
            "data parallelism, which maskbit_tpu_torch does not port; use VQGAN+Discriminator")
    ema_kwargs = dict(ema_kwargs or {})
    use_adaptive = loss_cfg.discriminator_gradient_penalty == "adopt_weight"
    batch_disc_passes = isinstance(discriminator, NLayerDiscriminatorv2)
    names = {id(p): n for n, p in model.named_parameters()}

    def train_step(state: TokenizerTrainState, images: torch.Tensor):
        images = images.float()
        step = state.step
        disc_trainable = step >= loss_cfg.discriminator_start
        gen_params = state.gen_opt.params
        disc_params = state.disc_opt.params

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
        with record_function("tokenizer/all_reduce"):
            all_reduce_mean_(grads)
        with record_function("tokenizer/optimizer"):
            metrics["grad_norm"] = global_norm(grads)
            if log_param_grad_norms:
                metrics.update(per_param_grad_norms([names[id(p)] for p in gen_params], grads))
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
                all_reduce_mean_(d_grads)
                state.disc_opt.step(d_grads)
        else:
            zero = images.new_zeros(())
            d_metrics = {k: zero for k in ("discriminator_loss", "logits_real", "logits_fake",
                                           "lecam_loss")}
        discriminator.requires_grad_(True)  # as the step found it

        if state.ema is not None:
            with record_function("tokenizer/ema"):
                ema_update(state.ema, model, **ema_kwargs)
        state.step += 1
        return state, mean_across_processes(
            {**metrics, **d_metrics, "train/total_loss": total.detach()})

    return train_step


def trainable_parameters(model: nn.Module, finetune_decoder: bool) -> list:
    """The parameters the generator's optimizer updates: the decoder's alone
    in `finetune_decoder` mode (the JAX CLI's `optax.masked`, which leaves
    the rest untouched, weight decay included), else all."""
    module = model.decoder if finetune_decoder else model
    return [p for p in module.parameters() if p.requires_grad]
