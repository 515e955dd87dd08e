"""Masked-language-modeling loss for Stage-II training.

Counterpart of `maskbit_tpu/losses/mlm.py`: label-smoothed cross entropy
over ALL positions (torch convention: (1-eps) * NLL(target) + eps *
mean_c NLL(c)), the masked-only loss and accuracy as mask-weighted means,
`correct_tokens ** m` over the m codebook splits, and the optional
`sum_splits` scaling. Computed in float32 whatever the logits' dtype.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch


class MLMLossConfig(NamedTuple):
    label_smoothing: float = 0.1
    sum_splits: bool = False

    @classmethod
    def from_config(cls, cfg) -> "MLMLossConfig":
        return cls(label_smoothing=cfg.get("label_smoothing", 0.1),
                   sum_splits=cfg.get("sum_splits", False))


def mlm_loss(logits: torch.Tensor, targets: torch.Tensor, masks: torch.Tensor,
             cfg: MLMLossConfig = MLMLossConfig()) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits (b, n, m, C), targets (b, n, m) ints, masks (b, n, m) bool."""
    m = logits.shape[2]
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll_target = -torch.gather(log_probs, -1, targets.long()[..., None])[..., 0]
    ce = (1.0 - cfg.label_smoothing) * nll_target - cfg.label_smoothing * log_probs.mean(-1)
    loss = ce.mean()

    with torch.no_grad():
        correct = (logits.argmax(-1) == targets).float()
        correct_tokens = correct.mean() ** m
    mask_f = masks.float()
    denom = mask_f.sum().clamp(min=1.0)
    masked_loss = (ce * mask_f).sum() / denom
    masked_correct_tokens = ((correct * mask_f).sum() / denom) ** m

    if cfg.sum_splits:
        loss = loss * m
        masked_loss = masked_loss * m
    return loss, dict(mlm_loss=loss, correct_tokens=correct_tokens,
                      masked_token_loss=masked_loss,
                      masked_correct_tokens=masked_correct_tokens)
