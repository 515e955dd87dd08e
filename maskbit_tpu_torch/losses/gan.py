"""GAN loss functions and the start gate.

Counterpart of `maskbit_tpu/losses/gan.py`: hinge, vanilla and
non-saturating discriminator and generator losses (the non-saturating
ones through the numerically stable sigmoid cross-entropy), the LeCam
regulariser and `adopt_weight`. As in the original repo, `G_LOSSES`
maps "vanilla" to the hinge generator loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def adopt_weight(weight: float, global_step: int, threshold: int = 0, value: float = 0.0) -> float:
    """`weight` from step `threshold` on, `value` before it."""
    return value if global_step < threshold else weight


def compute_lecam_loss(logits_real_mean: torch.Tensor, logits_fake_mean: torch.Tensor,
                       ema_logits_real_mean: torch.Tensor,
                       ema_logits_fake_mean: torch.Tensor) -> torch.Tensor:
    """LeCam: relu(real - ema_fake)^2 + relu(ema_real - fake)^2 (means)."""
    lecam = torch.mean(F.relu(logits_real_mean - ema_logits_fake_mean) ** 2)
    return lecam + torch.mean(F.relu(ema_logits_real_mean - logits_fake_mean) ** 2)


def hinge_g_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    return -torch.mean(logits_fake)


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    loss_real = torch.mean(F.relu(1.0 - logits_real))
    loss_fake = torch.mean(F.relu(1.0 + logits_fake))
    return 0.5 * (loss_real + loss_fake)


def sigmoid_cross_entropy_with_logits(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """max(x, 0) - x * z + log1p(exp(-|x|))."""
    zeros = torch.zeros_like(logits)
    cond = logits >= zeros
    relu_logits = torch.where(cond, logits, zeros)
    neg_abs_logits = torch.where(cond, -logits, logits)
    return relu_logits - logits * label + torch.log1p(torch.exp(neg_abs_logits))


def non_saturating_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    real = torch.mean(sigmoid_cross_entropy_with_logits(logits_real, torch.ones_like(logits_real)))
    fake = torch.mean(sigmoid_cross_entropy_with_logits(logits_fake, torch.zeros_like(logits_fake)))
    return real + fake


def non_saturating_g_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    return torch.mean(sigmoid_cross_entropy_with_logits(logits_fake, torch.ones_like(logits_fake)))


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.softplus(-logits_real)) + torch.mean(F.softplus(logits_fake)))


D_LOSSES = {"hinge": hinge_d_loss, "vanilla": vanilla_d_loss,
            "non-saturating": non_saturating_d_loss}
G_LOSSES = {"hinge": hinge_g_loss, "vanilla": hinge_g_loss,
            "non-saturating": non_saturating_g_loss}
