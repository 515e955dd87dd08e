"""The composite VQGAN loss of Stage-I tokenizer training.

Counterpart of `maskbit_tpu/losses/vqgan.py`:
  * `generator_loss`: the weighted L2 or L1 reconstruction, the perceptual
    loss, the quantizer's losses (with entropy annealing: the entropy loss
    is added again with weight max(0, 1 - step / annealing_steps) * factor)
    and the GAN loss weighted by the adaptive weight and by
    `discriminator_factor`, gated to 0 before `discriminator_start`;
  * `nll_loss_only`, the numerator loss of the adaptive weight;
  * `discriminator_loss`: hinge, vanilla or non-saturating, gated likewise,
    plus LeCam against EMA logit means (`LecamState`, decay `ema_decay`,
    the loss's own EMA and not the model's);
  * `calculate_adaptive_weight` = ||grad nll|| / (||grad g|| + 1e-4),
    clamped to [0, 1e4], on the decoder's last convolution.
Metrics come back detached, under the JAX package's keys.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from maskbit_tpu_torch.losses import gan


class VQGANLossConfig(NamedTuple):
    reconstruction_loss: str = "l2"
    reconstruction_weight: float = 1.0
    quantizer_weight: float = 1.0
    perceptual_loss: str = "lpips"
    perceptual_weight: float = 1.0
    discriminator_loss: str = "hinge"
    discriminator_factor: float = 1.0
    discriminator_weight: float = 1.0
    discriminator_start: int = 0
    discriminator_gradient_penalty: str = "none"  # "none" | "adopt_weight"
    discriminator_penalty_cost: float = 10.0
    lecam_regularization_weight: float = 0.0
    ema_decay: float = 0.999
    entropy_annealing_steps: int = 2000
    entropy_annealing_factor: float = 0.0

    @classmethod
    def from_config(cls, loss_cfg) -> "VQGANLossConfig":
        """From a `losses` config node; unknown loss names raise."""
        checks = (("discriminator_loss", "hinge", ("hinge", "vanilla", "non-saturating")),
                  ("reconstruction_loss", "l2", ("l2", "l1")),
                  ("discriminator_gradient_penalty", "none", ("none", "adopt_weight")))
        for key, default, allowed in checks:
            if loss_cfg.get(key, default) not in allowed:
                raise ValueError(f"losses.{key} must be one of {allowed}")
        return cls(**{field: loss_cfg.get(field, default)
                      for field, default in cls._field_defaults.items()})


class LecamState(NamedTuple):
    """The EMA logit means of the LeCam regulariser (float32 scalars)."""

    ema_real_logits_mean: torch.Tensor
    ema_fake_logits_mean: torch.Tensor

    @classmethod
    def init(cls, device=None) -> "LecamState":
        return cls(torch.zeros((), device=device), torch.zeros((), device=device))


def reconstruction_loss_fn(cfg: VQGANLossConfig, inputs: torch.Tensor,
                           reconstructions: torch.Tensor) -> torch.Tensor:
    diff = inputs.float() - reconstructions.float()
    loss = diff.abs().mean() if cfg.reconstruction_loss == "l1" else (diff**2).mean()
    return loss * cfg.reconstruction_weight


def calculate_adaptive_weight(nll_grads: torch.Tensor, g_grads: torch.Tensor) -> torch.Tensor:
    """||nll_grads|| / (||g_grads|| + 1e-4), clamped to [0, 1e4], detached."""
    d_weight = torch.linalg.vector_norm(nll_grads) / (torch.linalg.vector_norm(g_grads) + 1e-4)
    return d_weight.clamp(0.0, 1e4).detach()


def generator_loss(cfg: VQGANLossConfig, inputs: torch.Tensor, reconstructions: torch.Tensor,
                   extra_result_dict: Dict[str, torch.Tensor], global_step: int,
                   perceptual_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                   logits_fake: Optional[torch.Tensor] = None, d_weight=1.0
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, metrics). `logits_fake` is the discriminator's output on
    the reconstructions (gradients reach the generator through it), or None;
    `d_weight` the adaptive weight (1 when it is off)."""
    recon = reconstruction_loss_fn(cfg, inputs, reconstructions)
    perceptual = torch.mean(perceptual_fn(inputs, reconstructions))
    zero = recon.new_zeros(())
    discriminator_factor = gan.adopt_weight(cfg.discriminator_factor, global_step,
                                            threshold=cfg.discriminator_start)
    if logits_fake is not None:
        g_loss = gan.G_LOSSES[cfg.discriminator_loss](logits_fake.float())
    else:
        g_loss, discriminator_factor = zero, 0.0
    d_weight = torch.as_tensor(d_weight, dtype=torch.float32, device=recon.device)
    d_weight = d_weight * cfg.discriminator_weight

    quantizer_loss = extra_result_dict["quantizer_loss"]
    if cfg.entropy_annealing_factor > 0.0:
        anneal = max(0.0, 1.0 - float(global_step) / cfg.entropy_annealing_steps)
        quantizer_loss = quantizer_loss + (
            anneal * cfg.entropy_annealing_factor * extra_result_dict["entropy_loss"])

    weighted_gan = d_weight * discriminator_factor * g_loss
    total_loss = (recon + cfg.perceptual_weight * perceptual
                  + cfg.quantizer_weight * quantizer_loss + weighted_gan)
    loss_dict = dict(
        total_loss=total_loss, reconstruction_loss=recon,
        perceptual_loss=cfg.perceptual_weight * perceptual,
        quantizer_loss=cfg.quantizer_weight * quantizer_loss,
        weighted_gan_loss=weighted_gan,
        discriminator_factor=torch.tensor(float(discriminator_factor), device=recon.device),
        commitment_loss=extra_result_dict["commitment_loss"],
        entropy_loss=extra_result_dict["entropy_loss"],
        per_sample_entropy=extra_result_dict["per_sample_entropy"],
        avg_entropy=extra_result_dict["avg_entropy"],
        d_weight=d_weight, gan_loss=g_loss)
    if "codebook_loss" in extra_result_dict:
        loss_dict["codebook_loss"] = extra_result_dict["codebook_loss"]
    return total_loss, {k: torch.as_tensor(v).detach() for k, v in loss_dict.items()}


def nll_loss_only(cfg: VQGANLossConfig, inputs: torch.Tensor, reconstructions: torch.Tensor,
                  perceptual_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
                  ) -> torch.Tensor:
    """reconstruction + perceptual_weight * perceptual."""
    recon = reconstruction_loss_fn(cfg, inputs, reconstructions)
    return recon + cfg.perceptual_weight * torch.mean(perceptual_fn(inputs, reconstructions))


def discriminator_loss(cfg: VQGANLossConfig, logits_real: torch.Tensor,
                       logits_fake: torch.Tensor, global_step: int, lecam_state: LecamState
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], LecamState]:
    """(loss, metrics, the next LeCam state) from the discriminator's logits
    on the real images and on the detached reconstructions."""
    logits_real, logits_fake = logits_real.float(), logits_fake.float()
    discriminator_factor = gan.adopt_weight(cfg.discriminator_factor, global_step,
                                            threshold=cfg.discriminator_start)
    d_loss = discriminator_factor * gan.D_LOSSES[cfg.discriminator_loss](logits_real, logits_fake)
    lecam_loss = logits_real.new_zeros(())
    new_state = lecam_state
    if cfg.lecam_regularization_weight > 0.0:
        real_mean, fake_mean = logits_real.mean(), logits_fake.mean()
        lecam_loss = gan.compute_lecam_loss(
            real_mean, fake_mean, lecam_state.ema_real_logits_mean,
            lecam_state.ema_fake_logits_mean) * cfg.lecam_regularization_weight
        new_state = LecamState(
            lecam_state.ema_real_logits_mean * cfg.ema_decay
            + real_mean.detach() * (1 - cfg.ema_decay),
            lecam_state.ema_fake_logits_mean * cfg.ema_decay
            + fake_mean.detach() * (1 - cfg.ema_decay))
    d_loss = d_loss + lecam_loss
    loss_dict = dict(discriminator_loss=d_loss.detach(), logits_real=logits_real.mean().detach(),
                     logits_fake=logits_fake.mean().detach(), lecam_loss=lecam_loss.detach())
    return d_loss, loss_dict, new_state
