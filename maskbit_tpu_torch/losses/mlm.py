"""Masked-language-modeling loss for Stage-II training.

Counterpart of `maskbit_tpu/losses/mlm.py`: label-smoothed cross entropy
over ALL positions (torch convention: (1-eps) * NLL(target) + eps *
mean_c NLL(c)), the masked-only loss and accuracy as mask-weighted means,
`correct_tokens ** m` over the m codebook splits, and the optional
`sum_splits` scaling. Computed in float32 whatever the logits' dtype.
Across processes the returned loss is this rank's mean over its rows (its
gradients are averaged over the batch group), while the metrics are the
global batch's, as JAX computes them over the global array: the sums and
the denominators are summed over the batch group (the ranks that hold
different rows) before the divisions and powers.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from maskbit_tpu_torch.parallel.mesh import all_reduce_mean_, batch_group


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
        mask_f = masks.float()
        # the batch shards' mean of each sum, so the ratios below are global
        sums = torch.stack([ce.sum(), correct.sum(), (ce * mask_f).sum(),
                            (correct * mask_f).sum(), mask_f.sum()])
        shards = batch_group()
        ce_sum, correct_sum, masked_ce, masked_correct, mask_count = all_reduce_mean_(
            [sums], shards)[0]
        denom = mask_count.clamp(min=1.0 / shards.size)
        n, scale = ce.numel(), (m if cfg.sum_splits else 1)
    if cfg.sum_splits:
        loss = loss * m
    return loss, dict(mlm_loss=ce_sum / n * scale, correct_tokens=(correct_sum / n) ** m,
                      masked_token_loss=masked_ce / denom * scale,
                      masked_correct_tokens=(masked_correct / denom) ** m)
