"""BERT-style bidirectional transformer blocks, inference only.

Counterpart of `maskbit_tpu/nn/transformer.py`. Parameter names follow the
original repo's state dict (`layers.{i}.0.mha.in_proj_weight`,
`layers.{i}.1.net.0.weight`, ...), so weights exported from the JAX package
(`compat/torch_export.py`) and zoo checkpoints load strictly.

Compute runs in `dtype` (weights are cast on use); softmax and LayerNorm
(eps 1e-12) run in float32. Postnorm `BertAttention` with
`attention_impl="fused"` goes through the hand-written attention block
(`nn/attention_block.py`) at any sequence length whenever the module is in
eval mode; prenorm and `attention_impl="einsum"` use plain torch ops.
Dropout is a no-op in eval mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from maskbit_tpu_torch.nn.attention_block import fused_attention_block

LAYERNORM_EPS = 1e-12


def layer_norm_f32(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm computed in float32 (output stays float32)."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps)


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`layer` applied in x's dtype."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class MultiHeadSelfAttention(nn.Module):
    """torch-MHA parameter layout: packed `in_proj_weight` (3E, E) and
    `in_proj_bias`, plus `out_proj`."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.attn_drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, e = x.shape
        d = e // self.num_heads
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype), self.in_proj_bias.to(x.dtype))
        q, k, v = qkv.view(b, n, 3, self.num_heads, d).unbind(2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * d**-0.5
        weights = self.attn_drop(torch.softmax(logits.float(), dim=-1).to(x.dtype))
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, n, e)
        return linear(self.out_proj, out)


class BertAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 use_prenorm: bool = False, attention_impl: str = "einsum"):
        super().__init__()
        if attention_impl not in ("einsum", "fused"):
            raise ValueError(f"Unknown attention_impl {attention_impl!r}")
        self.use_prenorm, self.attention_impl = use_prenorm, attention_impl
        self.mha = MultiHeadSelfAttention(embed_dim, num_heads, dropout)
        self.norm = nn.LayerNorm(embed_dim, eps=LAYERNORM_EPS)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.attention_impl == "fused" and not self.use_prenorm and not self.training:
            mha, dt = self.mha, x.dtype
            return fused_attention_block(
                x.contiguous(),
                mha.in_proj_weight.to(dt).t(),
                mha.in_proj_bias.float(),
                mha.out_proj.weight.to(dt).t(),
                mha.out_proj.bias.float(),
                self.norm.weight.float(),
                self.norm.bias.float(),
                num_heads=mha.num_heads,
                eps=LAYERNORM_EPS,
            )
        if self.use_prenorm:
            y = layer_norm_f32(self.norm, x).to(x.dtype)
            return self.drop(self.mha(y)) + x
        return layer_norm_f32(self.norm, self.drop(self.mha(x)) + x).to(x.dtype)


class BertFeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0,
                 use_prenorm: bool = False):
        super().__init__()
        self.use_prenorm = use_prenorm
        self.norm = nn.LayerNorm(dim, eps=LAYERNORM_EPS)
        self.net = nn.Sequential(nn.Linear(dim, hidden_dim), nn.GELU(),
                                 nn.Linear(hidden_dim, dim), nn.Dropout(dropout))

    def _net(self, h: torch.Tensor) -> torch.Tensor:
        fc1, _, fc2, drop = self.net
        # exact-erf GELU; torch evaluates it in float32 for bf16 inputs
        return drop(linear(fc2, F.gelu(linear(fc1, h))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_prenorm:
            return self._net(layer_norm_f32(self.norm, x).to(x.dtype)) + x
        return layer_norm_f32(self.norm, self._net(x) + x).to(x.dtype)


class TransformerEncoder(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, mlp_dim: int,
                 dropout: float = 0.0, use_prenorm: bool = False,
                 attention_impl: str = "einsum"):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([
                BertAttention(dim, heads, dropout, use_prenorm, attention_impl),
                BertFeedForward(dim, mlp_dim, dropout, use_prenorm),
            ])
            for _ in range(depth)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for attn, ffn in self.layers:
            x = ffn(attn(x))
        return x
