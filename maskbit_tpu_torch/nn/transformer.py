"""BERT-style bidirectional transformer blocks.

Counterpart of `maskbit_tpu/nn/transformer.py`. Parameter names follow the
original repo's state dict (`layers.{i}.0.mha.in_proj_weight`,
`layers.{i}.1.net.0.weight`, ...), so weights exported from the JAX package
(`compat/torch_export.py`) and zoo checkpoints load strictly.

Compute runs in x's dtype (weights are cast on use); softmax and LayerNorm
(eps 1e-12) run in float32.
  * Eval mode: postnorm `BertAttention` with `attention_impl="fused"` goes
    through the hand-written attention block (`nn/attention_block.py`) at
    any sequence length; prenorm and `attention_impl="einsum"` use plain
    torch ops. Dropout is a no-op.
  * Training mode: attention-probability dropout at `attention_dropout`
    (None: `dropout`, torch-MHA parity). With `fused_dropout` and a rate
    above 0 it goes through `nn/dropout_attention.dropout_attention` (the
    hand-written forward and backward kernels on the card), with one uint32
    seed per (batch, head); otherwise dropout applies to the softmax
    weights. Every mask and seed comes from the step's `DropoutRng`, never
    from torch's global generator; a training-mode forward with a rate
    above 0 and no `DropoutRng` raises.
  * `remat` (training mode, gradients on): each `BertAttention` and
    `BertFeedForward` layer runs under `torch.utils.checkpoint`
    (non-reentrant) and is computed again in the backward pass. The
    checkpoint's own RNG stashing covers only torch's default generators,
    not the step's explicit one, so the encoder notes the `DropoutRng`'s
    position before each layer and the recompute draws again from there:
    the same masks and seeds, so remat on and off give the same loss and
    gradients. The recompute launches the dropout-attention forward kernel
    a second time.
  * Tensor parallelism (`parallel/zero.py` sets `tensor_group` on each
    `MultiHeadSelfAttention` and `BertFeedForward` and cuts their weights
    to the rank's share): q, k and v of the rank's heads [t h/T, (t+1)
    h/T), the dropout-attention kernels run on those h/T heads, and
    `out_proj` takes the matching columns; `fc1` its chunk of rows and
    `fc2` the matching columns. Each layer's input goes through Megatron's
    `copy_to_group` and its partial output through `reduce_from_group`
    (one all-reduce over the tensor group) before the bias. Every draw is
    made for the whole layer and sliced: the (b, h) seed table's columns
    of the rank's heads (the kernel's mask is a hash of (row, col, seed),
    so each rank's mask is the one-process mask's heads, bit for bit), the
    softmax-weight dropout's mask likewise, and the hidden dropout's masks
    whole on every rank of the group, which shares one step stream. The
    attention block at inference needs whole weights
    (`ShardedParams.whole_weights`), as JAX's `need_tensor_1`.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from maskbit_tpu_torch.nn.attention_block import fused_attention_block
from maskbit_tpu_torch.nn.dropout_attention import dropout_attention
from maskbit_tpu_torch.parallel.mesh import copy_to_group, reduce_from_group

LAYERNORM_EPS = 1e-12


class DropoutRng:
    """The randomness of one training step's dropouts: masks and attention
    seeds drawn from `generator`, or, for tests, attention seed tables
    injected in call order (one (b, h) table per attention layer call)."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 attention_seeds: Optional[Iterable] = None):
        if generator is None and attention_seeds is None:
            raise ValueError("DropoutRng needs a torch.Generator or injected seeds")
        self.generator = generator
        self._seeds = None if attention_seeds is None else list(attention_seeds)
        self._next_seed = 0

    def attention_seeds(self, b: int, h: int, device, heads: Optional[slice] = None
                        ) -> torch.Tensor:
        """(b, h) int64 seeds in [0, 2^32); with `heads`, those columns of
        the table drawn for all h heads."""
        if self._seeds is not None:
            table = self._seeds[self._next_seed]
            self._next_seed += 1
            table = torch.as_tensor(np.asarray(table, np.int64), device=device)
        else:
            table = torch.randint(0, 2**32, (b, h), generator=self.generator, device=device,
                                  dtype=torch.int64)
        return table if heads is None else table[:, heads].contiguous()

    def position(self) -> Tuple[Optional[torch.Tensor], int]:
        """Where the draws stand: the generator's state and the next
        injected table."""
        return (None if self.generator is None else self.generator.get_state(),
                self._next_seed)

    def _seek(self, position: Tuple[Optional[torch.Tensor], int]) -> None:
        state, self._next_seed = position
        if state is not None:
            self.generator.set_state(state)

    @contextlib.contextmanager
    def replay(self, position: Tuple[Optional[torch.Tensor], int]) -> Iterator[None]:
        """Inside the block the draws start again from `position`; on exit
        they go on from where they stood before it."""
        now = self.position()
        self._seek(position)
        try:
            yield
        finally:
            self._seek(now)

    def dropout(self, x: torch.Tensor, p: float, heads: Optional[Tuple[int, slice]] = None
                ) -> torch.Tensor:
        """Keep with probability 1 - p, kept values scaled by 1 / (1 - p).
        With `heads` (h, cols), x holds those columns of dim 1 of an array
        with h there, and the mask is drawn for that array and sliced."""
        if self.generator is None:
            raise ValueError("hidden dropout needs the step's torch.Generator")
        shape = x.shape if heads is None else (x.shape[0], heads[0]) + tuple(x.shape[2:])
        keep = torch.rand(shape, generator=self.generator, device=x.device) < 1.0 - p
        if heads is not None:
            keep = keep[:, heads[1]]
        return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, p: float, training: bool, rng: Optional[DropoutRng]) -> torch.Tensor:
    """Dropout at rate p in training mode; a no-op otherwise or at p = 0."""
    if not training or p == 0.0:
        return x
    if rng is None:
        raise ValueError("training-mode dropout needs the step's DropoutRng")
    return rng.dropout(x, p)


def layer_norm_f32(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm computed in float32 (output stays float32)."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps)


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`layer` applied in x's dtype."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class MultiHeadSelfAttention(nn.Module):
    """torch-MHA parameter layout: packed `in_proj_weight` (3E, E) and
    `in_proj_bias`, plus `out_proj`. With `tensor_group` set, the weights
    are the rank's share of the heads (module docstring)."""

    tensor_group = None

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 attention_dropout: Optional[float] = None, fused_dropout: bool = False):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.fused_dropout = fused_dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.attn_drop = nn.Dropout(dropout if attention_dropout is None else attention_dropout)

    def _output(self, out: torch.Tensor) -> torch.Tensor:
        if self.tensor_group is None:
            return linear(self.out_proj, out)
        partial = F.linear(out, self.out_proj.weight.to(out.dtype))
        return reduce_from_group(partial, self.tensor_group) + self.out_proj.bias.to(out.dtype)

    def forward(self, x: torch.Tensor, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        b, n, e = x.shape
        d = e // self.num_heads
        tg = self.tensor_group
        h = self.num_heads if tg is None else self.num_heads // tg.size
        heads = None if tg is None else slice(tg.index * h, (tg.index + 1) * h)
        p = self.attn_drop.p
        if tg is not None:
            x = copy_to_group(x, tg)
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype), self.in_proj_bias.to(x.dtype))
        q, k, v = qkv.view(b, n, 3, h, d).unbind(2)
        if self.training and p > 0.0 and self.fused_dropout:
            if rng is None:
                raise ValueError("training-mode dropout needs the step's DropoutRng")
            seeds = rng.attention_seeds(b, self.num_heads, x.device, heads)
            out = dropout_attention(q, k, v, seeds, p)
            return self._output(out.reshape(b, n, h * d))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * d**-0.5
        weights = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        if self.training and p > 0.0:
            if rng is None:
                raise ValueError("training-mode dropout needs the step's DropoutRng")
            weights = rng.dropout(weights, p, None if heads is None else (self.num_heads, heads))
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, n, h * d)
        return self._output(out)


class BertAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 use_prenorm: bool = False, attention_impl: str = "einsum",
                 attention_dropout: Optional[float] = None, fused_dropout: bool = False):
        super().__init__()
        if attention_impl not in ("einsum", "fused"):
            raise ValueError(f"Unknown attention_impl {attention_impl!r}")
        self.use_prenorm, self.attention_impl = use_prenorm, attention_impl
        self.mha = MultiHeadSelfAttention(embed_dim, num_heads, dropout, attention_dropout,
                                          fused_dropout)
        self.norm = nn.LayerNorm(embed_dim, eps=LAYERNORM_EPS)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        if self.attention_impl == "fused" and not self.use_prenorm and not self.training:
            if self.mha.tensor_group is not None:
                raise ValueError("the attention block runs on whole weights: lend the module "
                                 "whole weights first (ShardedParams.whole_weights)")
            # the vectors go as they are stored (f32 or bf16; the kernels widen
            # bf16), and weights already in x's dtype are not copied: with
            # the serving generator's bf16 weights a call launches only the
            # block's kernels
            mha, dt = self.mha, x.dtype
            return fused_attention_block(
                x.contiguous(),
                mha.in_proj_weight.to(dt).t(),
                mha.in_proj_bias,
                mha.out_proj.weight.to(dt).t(),
                mha.out_proj.bias,
                self.norm.weight,
                self.norm.bias,
                num_heads=mha.num_heads,
                eps=LAYERNORM_EPS,
            )
        p = self.drop.p
        if self.use_prenorm:
            y = layer_norm_f32(self.norm, x).to(x.dtype)
            return dropout(self.mha(y, rng), p, self.training, rng) + x
        attn = dropout(self.mha(x, rng), p, self.training, rng)
        return layer_norm_f32(self.norm, attn + x).to(x.dtype)


class BertFeedForward(nn.Module):
    tensor_group = None  # set: fc1 holds a chunk of the rows, fc2 its columns

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0,
                 use_prenorm: bool = False):
        super().__init__()
        self.use_prenorm = use_prenorm
        self.norm = nn.LayerNorm(dim, eps=LAYERNORM_EPS)
        self.net = nn.Sequential(nn.Linear(dim, hidden_dim), nn.GELU(),
                                 nn.Linear(hidden_dim, dim), nn.Dropout(dropout))

    def _net(self, h: torch.Tensor, rng: Optional[DropoutRng]) -> torch.Tensor:
        fc1, _, fc2, drop = self.net
        tg = self.tensor_group
        if tg is None:
            # exact-erf GELU; torch evaluates it in float32 for bf16 inputs
            return dropout(linear(fc2, F.gelu(linear(fc1, h))), drop.p, self.training, rng)
        a = F.gelu(linear(fc1, copy_to_group(h, tg)))
        y = reduce_from_group(F.linear(a, fc2.weight.to(a.dtype)), tg) + fc2.bias.to(a.dtype)
        return dropout(y, drop.p, self.training, rng)

    def forward(self, x: torch.Tensor, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        if self.use_prenorm:
            return self._net(layer_norm_f32(self.norm, x).to(x.dtype), rng) + x
        return layer_norm_f32(self.norm, self._net(x, rng) + x).to(x.dtype)


def _recomputed(layer: nn.Module, x: torch.Tensor, rng: Optional[DropoutRng]) -> torch.Tensor:
    """`layer(x, rng)` with its activations computed again in the backward
    pass, from the same draws."""
    start = None if rng is None else rng.position()
    calls = 0

    def run(h):
        nonlocal calls
        calls += 1
        if calls == 1 or rng is None:
            return layer(h, rng)
        with rng.replay(start):
            return layer(h, rng)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class TransformerEncoder(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, mlp_dim: int,
                 dropout: float = 0.0, use_prenorm: bool = False,
                 attention_impl: str = "einsum", attention_dropout: Optional[float] = None,
                 fused_dropout: bool = False, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            nn.ModuleList([
                BertAttention(dim, heads, dropout, use_prenorm, attention_impl,
                              attention_dropout, fused_dropout),
                BertFeedForward(dim, mlp_dim, dropout, use_prenorm),
            ])
            for _ in range(depth)
        )

    def forward(self, x: torch.Tensor, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        if self.remat and self.training and torch.is_grad_enabled():
            for attn, ffn in self.layers:
                x = _recomputed(ffn, _recomputed(attn, x, rng), rng)
            return x
        for attn, ffn in self.layers:
            x = ffn(attn(x, rng), rng)
        return x
