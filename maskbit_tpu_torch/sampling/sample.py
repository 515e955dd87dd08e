"""Iterative confidence-based masked sampling (MaskGIT-style) with CFG.

Counterpart of `maskbit_tpu/sampling/sample.py`. The JAX `lax.scan` becomes
a Python loop; randomness comes from an explicit `torch.Generator` on the
model's device. Kept from the original sampler:
  * CFG on the doubled batch; guidance annealing none | linear | cosine;
  * confidence = probability of the sampled token, kept tokens pinned to
    +inf before the log;
  * Gumbel noise * randomize_temperature * (1 - progress) on log-confidence;
  * re-mask count = min(max(floor(ratio * num_maskable), 1), num_masked - 1),
    with num_masked taken from batch element 0;
  * threshold = sorted confidence at index count - 1; re-mask conf <= thr;
  * the final step's prediction is returned BEFORE its re-mask.
The same seed gives other tokens than the JAX sampler (the RNG streams
differ); `injected=(token_draws, gumbel_draws)` replaces both draws so the
two can be compared exactly.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from maskbit_tpu_torch.ops.bitops import combine_factorized_tokens
from maskbit_tpu_torch.ops.masking import get_masking_ratio

# demo default label cycle: goldfish, chicken, tiger cat, hourglass, ship,
# dog, race car, airliner, teddy
DEFAULT_LABELS = (1, 7, 282, 604, 724, 179, 751, 404, 850)


class SamplingConfig(NamedTuple):
    softmax_temperature: float = 1.0
    randomize_temperature: float = 4.5
    mask_schedule_strategy: str = "linear"
    num_steps: int = 12
    guidance_scale: float = 3.0
    mask_token: int = 1024
    patch_size: int = 16
    guidance_annealing: str = "none"
    use_sampling_annealing: bool = False
    scale_pow: float = 4.0
    codebook_size: int = 1024
    codebook_splits: int = 1

    @classmethod
    def from_config(cls, mlm_cfg, vq_cfg) -> "SamplingConfig":
        """Build from `model.mlm_model` + `model.vq_model` config nodes."""
        codebook_size = vq_cfg.get("codebook_size", 1024)
        splits = mlm_cfg.get("codebook_splits", 1)
        bits = int(math.log2(codebook_size))
        return cls(
            softmax_temperature=mlm_cfg.get("softmax_temperature", 1.0),
            randomize_temperature=mlm_cfg.get("randomize_temperature", 4.5),
            mask_schedule_strategy=mlm_cfg.get("gen_mask_schedule_strategy", "arccos"),
            num_steps=mlm_cfg.get("num_steps", 12),
            guidance_scale=mlm_cfg.get("guidance_scale", 3.0),
            mask_token=int(2 ** (bits // splits)),
            patch_size=16,
            guidance_annealing=mlm_cfg.get("guidance_annealing", "none"),
            use_sampling_annealing=mlm_cfg.get("use_sampling_annealing", False),
            scale_pow=mlm_cfg.get("scale_pow", 4.0),
            codebook_size=codebook_size,
            codebook_splits=splits,
        )


def _progress(cfg: SamplingConfig, step: int) -> torch.Tensor:
    return (torch.tensor(step, dtype=torch.float32) + 1.0) / cfg.num_steps


def _guidance_scale_at(cfg: SamplingConfig, step: int) -> torch.Tensor:
    """guidance_scale * anneal(step), float32."""
    frac = torch.tensor(step, dtype=torch.float32) / cfg.num_steps
    if cfg.guidance_annealing == "none":
        scale_step = torch.tensor(1.0)
    elif cfg.guidance_annealing == "linear":
        scale_step = frac
    elif cfg.guidance_annealing == "cosine":
        scale_step = 0.5 * (1.0 - torch.cos((frac**cfg.scale_pow) * math.pi))
    else:
        raise ValueError(f"Unknown guidance_annealing {cfg.guidance_annealing!r}")
    return cfg.guidance_scale * scale_step


def confidence_remask(cfg: SamplingConfig, step: int, mask: torch.Tensor,
                      masked_tokens: torch.Tensor, sampled_tokens: torch.Tensor,
                      probabilities: torch.Tensor, gumbel_noise: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-mask math of one sampling step with the categorical draw and the
    Gumbel noise given. Returns (predicted_tokens, new_masked_tokens)."""
    num_samples = mask.shape[0]
    num_maskable = mask.shape[1] * mask.shape[2]
    progress = _progress(cfg, step).to(mask.device)

    num_masked = mask[0].sum()  # batch element 0, as the original sampler
    predicted = torch.where(mask, sampled_tokens, masked_tokens)

    confidence = torch.gather(probabilities, -1, predicted[..., None].long())[..., 0]
    confidence = torch.where(mask, confidence, torch.inf)
    confidence = torch.log(confidence) + gumbel_noise * cfg.randomize_temperature * (
        1.0 - progress)

    mask_ratio = get_masking_ratio(progress, mode=cfg.mask_schedule_strategy)
    mask_len = torch.floor(mask_ratio * num_maskable)
    count = torch.minimum(torch.clamp(mask_len.to(torch.int32), min=1), num_masked - 1)

    sorted_confidence = torch.sort(confidence.reshape(num_samples, -1), dim=-1).values
    # count 0 wraps to the last column, as jnp.take does; no host sync
    col = torch.remainder(count - 1, sorted_confidence.shape[1]).reshape(1).long()
    threshold = sorted_confidence.index_select(1, col)[:, 0]

    should_mask = confidence <= threshold[:, None, None]
    new_masked = torch.where(should_mask, cfg.mask_token, predicted)
    return predicted, new_masked


def sample_tokens(logits_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
                  labels: torch.Tensor, cfg: SamplingConfig,
                  generator: Optional[torch.Generator] = None,
                  injected: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  ) -> torch.Tensor:
    """Run the iterative unmasking loop; returns the final (b, n, m) tokens.

    logits_fn: (tokens (b, n, m), labels (b,), drop_mask (b,)) -> logits
        (b, n, m, ecs).
    generator: draws the categorical samples and the Gumbel noise; on
        labels' device. Required unless `injected` is given.
    injected: (token_draws, gumbel_draws), each (num_steps, b, n, m),
        used in place of the draws.
    """
    if generator is None and injected is None:
        raise ValueError("sample_tokens needs a torch.Generator or injected draws")
    device = labels.device
    b = labels.shape[0]
    masked = torch.full((b, cfg.patch_size**2, cfg.codebook_splits), cfg.mask_token,
                        dtype=torch.int32, device=device)
    predicted = masked
    use_cfg = cfg.guidance_scale != 0.0
    if use_cfg:
        labels2 = torch.cat([labels, labels])
        drop2 = torch.arange(2 * b, device=device) >= b
    for step in range(cfg.num_steps):
        mask = masked == cfg.mask_token
        if use_cfg:
            logits_c, logits_u = logits_fn(torch.cat([masked, masked]), labels2, drop2).chunk(2)
            scale = _guidance_scale_at(cfg, step).to(device)
            # the difference is taken in the model's dtype, as in JAX
            logits = logits_c.float() + scale * (logits_c - logits_u).float()
        else:
            logits = logits_fn(masked, labels, torch.zeros(b, dtype=torch.bool, device=device))

        if cfg.use_sampling_annealing:
            temperature = 0.5 + 0.8 * (1.0 - _progress(cfg, step).to(device))
        else:
            temperature = cfg.softmax_temperature
        scaled = logits.float() / temperature
        if injected is None:
            # Gumbel-max categorical draw; -log(Exp(1)) is Gumbel(0, 1)
            expo = torch.empty_like(scaled).exponential_(generator=generator)
            sampled = torch.argmax(scaled - torch.log(expo), dim=-1).to(torch.int32)
            gumbel = -torch.log(torch.empty(sampled.shape, device=device)
                                .exponential_(generator=generator))
        else:
            sampled = torch.as_tensor(injected[0][step], dtype=torch.int32, device=device)
            gumbel = torch.as_tensor(injected[1][step], dtype=torch.float32, device=device)
        probabilities = torch.softmax(scaled, dim=-1)
        predicted, masked = confidence_remask(cfg, step, mask, masked, sampled,
                                              probabilities, gumbel)
    return predicted


def make_sampler(generator_model, tokenizer, cfg: SamplingConfig) -> Callable:
    """Build (images, tokens) = f(labels, generator=None, injected=None);
    one of `generator` and `injected` must be given.

    images are NHWC (b, H, W, 3) in the tokenizer's dtype, tokens are the
    combined (b, n) indices. Runs under `torch.inference_mode`."""

    @torch.inference_mode()
    def sample(labels: torch.Tensor, generator: Optional[torch.Generator] = None,
               injected: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        predicted = sample_tokens(generator_model, labels, cfg, generator, injected)
        tokens = combine_factorized_tokens(predicted, cfg.codebook_size, cfg.codebook_splits)
        return tokenizer.decode_tokens(tokens), tokens

    return sample


def default_labels(num_samples: int, generator: torch.Generator) -> torch.Tensor:
    """The demo label cycle plus one random label; repetitions FLOOR, so
    e.g. 15 requested gives 10 labels, as in the original."""
    rand = torch.randint(0, 999, (1,), generator=generator)
    base = torch.cat([torch.tensor(DEFAULT_LABELS), rand]).to(torch.int32)
    return base.repeat(max(1, num_samples // 10))[:num_samples]
