"""Codebook entropy losses.

Counterpart of `maskbit_tpu/ops/entropy.py`:
  * `clamp_log`, log(max(x, eps));
  * `entropy_loss_fn`, the per-sample entropy and the (gamma-scaled)
    entropy of the mean code distribution of softmax(affinity / T), dense
    (VQ's term over -distances);
  * `lfq_entropy_terms`, the same for the LFQ hypercube codebook, with
    affinity 2 z.c over all 2^K codes c in {-1, +1}^K. The log-partition is
    analytic, sum_k log(2 cosh(2 z_k / T)), and the sums stream over
    codebook chunks of `chunk_size` codes (one chunk when 2^K <= chunk_size;
    a chunk size that is not a power of two is rounded down to one), so the
    (rows, 2^K) matrix never exists.

`lfq_entropy_terms` is a `torch.autograd.Function`: its backward recomputes
each chunk's probabilities and applies the gradient analytically, so
nothing of a chunk is kept between the passes (at 18 bits and 4096 rows a
chunk is 64 MB, and there are 64). The affinity products run in full
float32 in both passes (`utils/precision.full_f32`, whatever the caller's
TF32 flags), as the JAX package's `Precision.HIGHEST`: with T = 0.01 a
TF32 product's ~1e-3 relative error becomes an O(1) error in the
probabilities.
"""

from __future__ import annotations

from typing import Tuple

import torch

from maskbit_tpu_torch.ops.bitops import indices_to_bits
from maskbit_tpu_torch.utils.precision import full_f32


def clamp_log(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """log(max(x, eps)), the original repo's clamped log."""
    return torch.log(x.clamp(min=eps))


def entropy_loss_fn(affinity: torch.Tensor, temperature: float, entropy_gamma: float = 1.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-sample entropy, gamma * entropy of the mean distribution) of
    softmax(affinity / temperature) over the last axis, in float32."""
    flat = affinity.reshape(-1, affinity.shape[-1]).float() / temperature
    probability = torch.softmax(flat, dim=-1)
    average_probability = probability.mean(dim=0)
    per_sample_entropy = -(probability * clamp_log(probability)).sum(dim=-1).mean()
    avg_entropy = (-average_probability * clamp_log(average_probability)).sum()
    return per_sample_entropy, avg_entropy * entropy_gamma


def _log2cosh(a: torch.Tensor) -> torch.Tensor:
    """log(2 cosh(a)) = |a| + log1p(exp(-2|a|)), stable for large |a|."""
    abs_a = a.abs()
    return abs_a + torch.log1p(torch.exp(-2.0 * abs_a))


def _chunk_codes(start: int, size: int, num_bits: int, device) -> torch.Tensor:
    """Codes start..start+size-1 of the LFQ codebook as ±1 bits (size, K),
    LSB first (`ops.bitops.codebook`'s rows)."""
    idx = torch.arange(start, start + size, dtype=torch.int32, device=device)
    return indices_to_bits(idx, num_bits)


class _LfqEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, num_bits, inv_t, chunk_size, eps):
        n_codes = 2**num_bits
        with full_f32():
            log_z = _log2cosh(2.0 * inv_t * rows).sum(dim=-1)  # (R,)
            psum = torch.zeros_like(log_z)
            avg_entropy = rows.new_zeros(())
            for start in range(0, n_codes, chunk_size):
                codes = _chunk_codes(start, chunk_size, num_bits, rows.device)
                p = torch.exp((2.0 * inv_t) * (rows @ codes.t()) - log_z[:, None])
                psum += (p * clamp_log(p, eps)).sum(dim=-1)
                avg_p = p.mean(dim=0)
                avg_entropy += (-avg_p * clamp_log(avg_p, eps)).sum()
        ctx.save_for_backward(rows, log_z)
        ctx.num_bits, ctx.inv_t, ctx.chunk_size, ctx.eps = num_bits, inv_t, chunk_size, eps
        return -psum.mean(), avg_entropy

    @staticmethod
    def backward(ctx, g_per_sample, g_avg):
        rows, log_z = ctx.saved_tensors
        num_bits, inv_t, chunk_size, eps = ctx.num_bits, ctx.inv_t, ctx.chunk_size, ctx.eps
        n_rows = rows.shape[0]
        grad = torch.zeros_like(rows)
        grad_log_z = torch.zeros_like(log_z)
        with full_f32():
            for start in range(0, 2**num_bits, chunk_size):
                codes = _chunk_codes(start, chunk_size, num_bits, rows.device)
                p = torch.exp((2.0 * inv_t) * (rows @ codes.t()) - log_z[:, None])
                avg_p = p.mean(dim=0)
                # d/dp of -mean_i sum_c p log(max(p, eps)) and of
                # sum_c -avg_p log(max(avg_p, eps)), avg_p = mean_i p
                d_p = (-g_per_sample / n_rows) * (clamp_log(p, eps) + (p > eps).float())
                d_p -= (g_avg / n_rows) * (clamp_log(avg_p, eps) + (avg_p > eps).float())
                d_logits = d_p * p  # p = exp(logits - log_z)
                grad_log_z -= d_logits.sum(dim=-1)
                grad += (2.0 * inv_t) * (d_logits @ codes)
            # d log_z / d rows = (2 / T) tanh(2 rows / T)
            grad += grad_log_z[:, None] * (2.0 * inv_t) * torch.tanh(2.0 * inv_t * rows)
        return grad, None, None, None, None


def lfq_entropy_terms(z: torch.Tensor, num_bits: int, temperature: float,
                      entropy_gamma: float = 1.0, chunk_size: int = 4096
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per_sample_entropy, gamma * avg_entropy) of
    `entropy_loss_fn(2 * z.reshape(-1, K) @ codebook(K).T, temperature, gamma)`,
    streamed over codebook chunks; differentiable in z."""
    rows = z.reshape(-1, num_bits).float()
    n_codes = 2**num_bits
    if n_codes <= chunk_size:
        chunk_size = n_codes
    elif n_codes % chunk_size != 0:
        chunk_size = 1 << (chunk_size.bit_length() - 1)
    per_sample_entropy, avg_entropy = _LfqEntropy.apply(rows, num_bits, 1.0 / temperature,
                                                        chunk_size, 1e-5)
    return per_sample_entropy, avg_entropy * entropy_gamma
