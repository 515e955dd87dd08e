"""Stage-II masked-token generator `LFQBert`, for inference and training.

Counterpart of `maskbit_tpu/models/generator.py` (`_GeneratorBase` and
`LFQBert`; `Bert` is not ported yet). Parameter names follow the original
repo's state dict (`input_proj`, `class_emb`, `pos_emb`, `first_layer.0`,
`transformer.layers.*`, `last_layer.{0,2}`, `prediction_layer`, buffer
`bits_to_indices`), so exported JAX weights and zoo checkpoints load with
`load_state_dict(strict=True)`.

* tokens (b, n, m) -> ±1 bits with masked positions zeroed;
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

from maskbit_tpu_torch.nn.transformer import (
    DropoutRng,
    TransformerEncoder,
    dropout,
    layer_norm_f32,
    linear,
)
from maskbit_tpu_torch.ops import bitops


class LFQBert(nn.Module):
    """Embedding-free generator: bit tokens in, factorized logits out."""

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

        self.input_proj = nn.Linear(codebook_splits * self.effective_bits, hidden_dim)
        self.class_emb = nn.Embedding(nclass + 1, hidden_dim)
        self.pos_emb = nn.Parameter(torch.empty(1, self.seq_len + 1, hidden_dim))
        self.first_layer = nn.Sequential(nn.LayerNorm(hidden_dim, eps=1e-12), nn.Dropout(dropout))
        self.transformer = TransformerEncoder(hidden_dim, depth, heads, mlp_dim, dropout,
                                              use_prenorm, attention_impl, attention_dropout,
                                              fused_attention_dropout, remat)
        if use_prenorm:
            self.norm_after_transformer = nn.LayerNorm(hidden_dim, eps=1e-12)
        self.last_layer = nn.Sequential(nn.Linear(hidden_dim, hidden_dim), nn.GELU(),
                                        nn.LayerNorm(hidden_dim, eps=1e-12))
        self.prediction_layer = nn.Linear(hidden_dim,
                                          codebook_splits * self.effective_codebook_size)
        self.register_buffer("bits_to_indices", torch.empty(self.effective_bits, dtype=torch.int32))
        self.reset_buffers()

    def reset_buffers(self) -> None:
        """Rebuild the deterministic buffer (after `to_empty`)."""
        self.bits_to_indices.copy_(bitops.bit_weights(self.effective_bits))

    @classmethod
    def from_config(cls, mlm_cfg, vq_cfg, dtype: torch.dtype = torch.float32) -> "LFQBert":
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

    def preprocess_tokens(self, img_tokens: torch.Tensor) -> torch.Tensor:
        """(b, n, m) indices -> (b, n, m*eb) ±1 bits, masked positions zeroed."""
        bits = bitops.indices_to_bits(img_tokens, self.effective_bits, dtype=self.dtype)
        bits = bits.masked_fill((img_tokens == self.mask_token)[..., None], 0.0)
        b, n = img_tokens.shape[:2]
        return bits.reshape(b, n, self.codebook_splits * self.effective_bits)

    def forward(self, img_tokens: torch.Tensor, class_labels: torch.Tensor,
                drop_label_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        dt = self.dtype
        cls_token = class_labels.reshape(-1).long()
        if drop_label_mask is not None:
            cls_token = torch.where(drop_label_mask.reshape(-1), self.drop_label, cls_token)
        cls_emb = F.embedding(cls_token, self.class_emb.weight.to(dt))[:, None, :]
        projected = linear(self.input_proj, self.preprocess_tokens(img_tokens))

        x = torch.cat([projected, cls_emb], dim=1) + self.pos_emb.to(dt)
        x = layer_norm_f32(self.first_layer[0], x).to(dt)
        x = dropout(x, self.first_layer[1].p, self.training, rng)
        x = self.transformer(x, rng)
        if self.use_prenorm:
            x = layer_norm_f32(self.norm_after_transformer, x).to(dt)
        dense, _, norm = self.last_layer
        x = F.gelu(linear(dense, x))  # exact erf, evaluated in float32
        x = layer_norm_f32(norm, x).to(dt)

        logits = linear(self.prediction_layer, x)
        b, n_plus_1 = logits.shape[:2]
        logits = logits.reshape(b, n_plus_1, self.codebook_splits, self.effective_codebook_size)
        return logits[:, : self.seq_len]


_TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]


def _trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """flax's truncated_normal(std): a standard normal truncated to [-2, 2]
    (inverse-CDF sampling), scaled so that the result has std `std`."""
    edge = math.erf(2.0 / math.sqrt(2.0))  # 2 * Phi(2) - 1
    t.uniform_(-edge, edge, generator=generator)
    t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(std / _TRUNC_STD)


@torch.no_grad()
def init_generator_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisation (its flax initialisers, drawn from
    `generator`): `in_proj_weight` xavier-uniform; every other matrix, the
    embeddings and `pos_emb` truncated normal with std 0.02; biases 0;
    LayerNorm scales 1."""
    for name, p in model.named_parameters():
        owner = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
        if isinstance(owner, nn.LayerNorm):
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("in_proj_weight"):
            bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            p.uniform_(-bound, bound, generator=generator)
        elif name.endswith("bias"):
            p.zero_()
        else:
            _trunc_normal_(p, 0.02, generator)
    model.reset_buffers()


def make_generator(model_cls: str, mlm_cfg, vq_cfg, dtype: torch.dtype = torch.float32):
    """Factory over the config's `model_cls` (only `lfq_bert` is ported)."""
    if model_cls == "lfq_bert":
        return LFQBert.from_config(mlm_cfg, vq_cfg, dtype=dtype)
    if model_cls == "bert":
        raise NotImplementedError("the Bert generator is not ported to PyTorch yet")
    raise ValueError(f"Unknown generator model_cls {model_cls!r}")
