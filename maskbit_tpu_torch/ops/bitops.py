"""Bit-token primitives: LFQ packing and factorized-codebook split/combine.

Counterpart of `maskbit_tpu/ops/bitops.py`, with the same semantics:
LSB-first packing, bits as {-1, +1} floats, int32 indices, factorized
split/combine by shift and mask.
"""

from __future__ import annotations

import math

import torch


def bit_weights(num_bits: int, device=None) -> torch.Tensor:
    """[2^0, 2^1, ..., 2^(K-1)] — LSB-first place values (int32)."""
    return torch.ones((), dtype=torch.int32, device=device) << torch.arange(
        num_bits, dtype=torch.int32, device=device)


def bits_to_indices(bits: torch.Tensor) -> torch.Tensor:
    """Pack ±1 bits (..., K) into int32 token indices (...,). LSB-first.
    Any strictly positive value counts as a 1-bit."""
    on = (bits > 0).to(torch.int32)
    return (on * bit_weights(bits.shape[-1], bits.device)).sum(-1, dtype=torch.int32)


def indices_to_bits(indices: torch.Tensor, num_bits: int,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Unpack int token indices (...,) into ±1 bits (..., K). LSB-first."""
    idx = indices.to(torch.int32)[..., None]
    shifts = torch.arange(num_bits, dtype=torch.int32, device=indices.device)
    bits01 = (idx >> shifts) & 1
    return (bits01 * 2 - 1).to(dtype)


def codebook(num_bits: int, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """The implicit LFQ codebook: all 2^K sign patterns, shape (2^K, K)."""
    return indices_to_bits(
        torch.arange(2**num_bits, dtype=torch.int32, device=device), num_bits, dtype)


def split_factorized_tokens(tokens: torch.Tensor, codebook_size: int, splits: int) -> torch.Tensor:
    """K-bit indices (..., n) -> (..., n, splits); group 0 holds the
    least-significant K/splits bits."""
    bit_shift = int(math.log2(codebook_size)) // splits
    bit_mask = (1 << bit_shift) - 1
    shifts = torch.arange(splits, dtype=torch.int32, device=tokens.device) * bit_shift
    return (tokens.to(torch.int32)[..., None] >> shifts) & bit_mask


def combine_factorized_tokens(tokens: torch.Tensor, codebook_size: int, splits: int) -> torch.Tensor:
    """Inverse of `split_factorized_tokens`: (..., n, splits) -> (..., n)."""
    bit_shift = int(math.log2(codebook_size)) // splits
    shifts = torch.arange(splits, dtype=torch.int32, device=tokens.device) * bit_shift
    return (tokens.to(torch.int32) << shifts).sum(-1, dtype=torch.int32)
