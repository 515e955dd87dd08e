"""Stage-II masked-token generators `Bert` and `LFQBert`, for inference
and training.

Counterpart of `maskbit_tpu/models/generator.py` (`_GeneratorBase`, `Bert`
and `LFQBert`). Parameter names follow the original repo's state dict
(`class_emb`, `pos_emb`, `first_layer.0`, `transformer.layers.*`,
`last_layer.{0,2}`; LFQBert's `input_proj`, `prediction_layer` and buffer
`bits_to_indices`; Bert's `tok_emb_list.{i}` and `bias.{i}`), so exported
JAX weights and zoo checkpoints load with `load_state_dict(strict=True)`.

* LFQBert: tokens (b, n, m) -> ±1 bits with masked positions zeroed, a
  linear projection in and a linear head out;
* Bert: one embedding table per split, summed, and the weight-tied head
  (a plain product, as the JAX package's einsum);
* the class token is appended AFTER the image tokens; `pos_emb` covers
  seq_len + 1 positions; `class_emb` has nclass + 1 rows, the last being the
  drop label;
* logits (b, n, m, ecs), sliced to seq_len.

In training mode the forward takes the step's `DropoutRng` (hidden dropout
at `dropout`, attention dropout at `attention_dropout`, through the
dropout-attention kernels when `fused_attention_dropout` is set). With
`remat` each transformer layer's activations are computed again in the
backward pass (`nn/transformer.py`), from the same draws.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from maskbit_tpu_torch.nn.conv import trunc_normal_
from maskbit_tpu_torch.nn.transformer import (
    DropoutRng,
    TransformerEncoder,
    dropout,
    layer_norm_f32,
    linear,
)
from maskbit_tpu_torch.ops import bitops


class _GeneratorBase(nn.Module):
    """The geometry and the trunk both generators share: `class_emb`,
    `pos_emb`, `first_layer`, `transformer`, `norm_after_transformer` and
    `last_layer`, registered between the subclass's `_build_input` and
    `_build_head` (the original repo's order)."""

    def __init__(self, img_size: int = 256, hidden_dim: int = 768,
                 codebook_size: int = 1024, codebook_splits: int = 1, depth: int = 24,
                 heads: int = 8, mlp_dim: int = 3072, dropout: float = 0.1,
                 nclass: int = 1000, input_stride: int = 16, use_prenorm: bool = False,
                 attention_impl: str = "einsum", attention_dropout: Optional[float] = None,
                 fused_attention_dropout: bool = False, remat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size, self.hidden_dim, self.nclass = img_size, hidden_dim, nclass
        self.codebook_size, self.codebook_splits = codebook_size, codebook_splits
        self.input_stride, self.use_prenorm, self.dtype = input_stride, use_prenorm, dtype
        self.seq_len = (img_size // input_stride) ** 2
        self.bits = int(math.log2(codebook_size))
        self.effective_bits = self.bits // codebook_splits
        self.effective_codebook_size = 2**self.effective_bits
        self.mask_token = self.effective_codebook_size
        self.drop_label = nclass

        self._build_input()
        self.class_emb = nn.Embedding(self.nclass + 1, hidden_dim)
        self.pos_emb = nn.Parameter(torch.empty(1, self.seq_len + 1, hidden_dim))
        self.first_layer = nn.Sequential(nn.LayerNorm(hidden_dim, eps=1e-12), nn.Dropout(dropout))
        self.transformer = TransformerEncoder(hidden_dim, depth, heads, mlp_dim, dropout,
                                              use_prenorm, attention_impl, attention_dropout,
                                              fused_attention_dropout, remat)
        if use_prenorm:
            self.norm_after_transformer = nn.LayerNorm(hidden_dim, eps=1e-12)
        self.last_layer = nn.Sequential(nn.Linear(hidden_dim, hidden_dim), nn.GELU(),
                                        nn.LayerNorm(hidden_dim, eps=1e-12))
        self._build_head()
        self.reset_buffers()

    def _build_input(self) -> None:
        raise NotImplementedError

    def _build_head(self) -> None:
        raise NotImplementedError

    def reset_buffers(self) -> None:
        """Rebuild the deterministic buffers (after `to_empty`)."""

    @classmethod
    def from_config(cls, mlm_cfg, vq_cfg, dtype: torch.dtype = torch.float32):
        """Build from `model.mlm_model` + `model.vq_model` config nodes."""
        return cls(
            img_size=mlm_cfg.get("img_size", 256),
            hidden_dim=mlm_cfg.get("hidden_dim", 768),
            codebook_size=vq_cfg.get("codebook_size", 1024),
            codebook_splits=mlm_cfg.get("codebook_splits", 1),
            depth=mlm_cfg.get("depth", 24),
            heads=mlm_cfg.get("heads", 8),
            mlp_dim=mlm_cfg.get("mlp_dim", 3072),
            dropout=mlm_cfg.get("dropout", 0.1),
            nclass=mlm_cfg.get("nclass", 1000),
            input_stride=mlm_cfg.get("input_stride", 16),
            use_prenorm=mlm_cfg.get("use_prenorm", False),
            attention_impl=mlm_cfg.get("attention_impl", "einsum"),
            attention_dropout=mlm_cfg.get("attention_dropout", None),
            fused_attention_dropout=mlm_cfg.get("fused_attention_dropout", False),
            remat=mlm_cfg.get("remat", False),
            dtype=dtype,
        )

    def _trunk(self, tok_embeddings: torch.Tensor, class_labels: torch.Tensor,
               drop_label_mask: Optional[torch.Tensor], rng: Optional[DropoutRng]
               ) -> torch.Tensor:
        """Image-token embeddings (b, n, d) and labels -> the head's input
        (b, n + 1, d), the class token last."""
        dt = self.dtype
        cls_token = class_labels.reshape(-1).long()
        if drop_label_mask is not None:
            cls_token = torch.where(drop_label_mask.reshape(-1), self.drop_label, cls_token)
        cls_emb = F.embedding(cls_token, self.class_emb.weight.to(dt))[:, None, :]

        x = torch.cat([tok_embeddings, cls_emb], dim=1) + self.pos_emb.to(dt)
        x = layer_norm_f32(self.first_layer[0], x).to(dt)
        x = dropout(x, self.first_layer[1].p, self.training, rng)
        x = self.transformer(x, rng)
        if self.use_prenorm:
            x = layer_norm_f32(self.norm_after_transformer, x).to(dt)
        dense, _, norm = self.last_layer
        x = F.gelu(linear(dense, x))  # exact erf, evaluated in float32
        return layer_norm_f32(norm, x).to(dt)


class LFQBert(_GeneratorBase):
    """Embedding-free generator: bit tokens in, factorized logits out."""

    def _build_input(self) -> None:
        self.input_proj = nn.Linear(self.codebook_splits * self.effective_bits, self.hidden_dim)

    def _build_head(self) -> None:
        self.prediction_layer = nn.Linear(self.hidden_dim,
                                          self.codebook_splits * self.effective_codebook_size)
        self.register_buffer("bits_to_indices", torch.empty(self.effective_bits, dtype=torch.int32))

    def reset_buffers(self) -> None:
        """Rebuild the deterministic buffer (after `to_empty`)."""
        self.bits_to_indices.copy_(bitops.bit_weights(self.effective_bits))

    def preprocess_tokens(self, img_tokens: torch.Tensor) -> torch.Tensor:
        """(b, n, m) indices -> (b, n, m*eb) ±1 bits, masked positions zeroed."""
        bits = bitops.indices_to_bits(img_tokens, self.effective_bits, dtype=self.dtype)
        bits = bits.masked_fill((img_tokens == self.mask_token)[..., None], 0.0)
        b, n = img_tokens.shape[:2]
        return bits.reshape(b, n, self.codebook_splits * self.effective_bits)

    def forward(self, img_tokens: torch.Tensor, class_labels: torch.Tensor,
                drop_label_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        projected = linear(self.input_proj, self.preprocess_tokens(img_tokens))
        x = self._trunk(projected, class_labels, drop_label_mask, rng)
        logits = linear(self.prediction_layer, x)
        b, n_plus_1 = logits.shape[:2]
        logits = logits.reshape(b, n_plus_1, self.codebook_splits, self.effective_codebook_size)
        return logits[:, : self.seq_len]


class Bert(_GeneratorBase):
    """Embedding-table generator with a weight-tied output head: per split
    a table `tok_emb_list.{i}` of ecs + 1 rows (the last is the mask token),
    the splits' embeddings summed; logits_i = x @ table_i[:ecs].T + `bias.{i}`,
    a learned (seq_len, ecs) bias per position."""

    def _build_input(self) -> None:
        self.tok_emb_list = nn.ModuleList(nn.Embedding(self.effective_codebook_size + 1,
                                                       self.hidden_dim)
                                          for _ in range(self.codebook_splits))

    def _build_head(self) -> None:
        self.bias = nn.ParameterList(nn.Parameter(torch.empty(self.seq_len,
                                                              self.effective_codebook_size))
                                     for _ in range(self.codebook_splits))

    def forward(self, img_tokens: torch.Tensor, class_labels: torch.Tensor,
                drop_label_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        dt, ecs = self.dtype, self.effective_codebook_size
        embedded = F.embedding(img_tokens[..., 0].long(), self.tok_emb_list[0].weight.to(dt))
        for i in range(1, self.codebook_splits):
            embedded = embedded + F.embedding(img_tokens[..., i].long(),
                                              self.tok_emb_list[i].weight.to(dt))
        x = self._trunk(embedded, class_labels, drop_label_mask, rng)[:, : self.seq_len]
        logits = [torch.matmul(x, table.weight[:ecs].to(dt).t()) + bias.to(dt)
                  for table, bias in zip(self.tok_emb_list, self.bias)]
        return torch.stack(logits, dim=2)  # (b, n, m, ecs)


@torch.no_grad()
def init_generator_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisation (its flax initialisers, drawn from
    `generator`): `in_proj_weight` xavier-uniform; every other matrix, the
    embeddings and `pos_emb` truncated normal with std 0.02; biases (Bert's
    per-position `bias.{i}` too) 0; LayerNorm scales 1."""
    for name, p in model.named_parameters():
        owner = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
        if isinstance(owner, nn.LayerNorm):
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("in_proj_weight"):
            bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            p.uniform_(-bound, bound, generator=generator)
        elif name.endswith("bias") or name.startswith("bias."):
            p.zero_()
        else:
            trunc_normal_(p, 0.02, generator)
    model.reset_buffers()


def make_generator(model_cls: str, mlm_cfg, vq_cfg, dtype: torch.dtype = torch.float32):
    """Factory over the config's `model_cls`: `bert` or `lfq_bert`."""
    if model_cls == "bert":
        return Bert.from_config(mlm_cfg, vq_cfg, dtype=dtype)
    if model_cls == "lfq_bert":
        return LFQBert.from_config(mlm_cfg, vq_cfg, dtype=dtype)
    raise ValueError(f"Unknown generator model_cls {model_cls!r}")
