"""Parameter trees of the JAX package -> the original repo's state dicts.

The port's own copy (numpy only) of the exporters in
`maskbit_tpu/compat/torch_export.py`: JAX (flax) parameter trees, given as
nested mappings of numpy arrays, become state dicts in the original repo's
layout, with the deterministic registered buffers rebuilt (LFQ
`quantize.bits_to_indices` / `quantize.codebook`, LFQBert
`bits_to_indices`). Every tokenizer parameter is exported, the encoder's
included. Renames and transposes: HWIO -> OIHW, packed qkv ->
`in_proj_weight`, norm `scale` -> `weight`.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Optional

import numpy as np


def _flatten(tree: Any, prefix: tuple = ()) -> Dict[tuple, np.ndarray]:
    out: Dict[tuple, np.ndarray] = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out.update(_flatten(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(value)
    return out


def _unmerge(part: str) -> str:
    """Inverse of torch_convert._merge_indices for one component:
    'res_blocks_1' -> 'res_blocks.1' (digit tokens become dot components,
    non-digit underscores like 'nin_shortcut' survive)."""
    tokens = part.split("_")
    parts = [tokens[0]]
    for tok in tokens[1:]:
        if tok.isdigit():
            parts.append(tok)
        else:
            parts[-1] = f"{parts[-1]}_{tok}"
    return ".".join(parts)


def _lfq_buffers(codebook_size: int) -> Dict[str, np.ndarray]:
    """The LFQ quantizer's registered buffers (lookup_free.py:38-43)."""
    token_bits = int(round(math.log2(codebook_size)))
    if 2**token_bits != codebook_size:
        raise ValueError(f"codebook_size {codebook_size} is not a power of 2")
    b2i = (2 ** np.arange(token_bits, dtype=np.int64)).astype(np.int32)
    codes = np.arange(codebook_size, dtype=np.int64)
    bits = ((codes[:, None] & b2i.astype(np.int64)) != 0).astype(np.float32)
    return {"bits_to_indices": b2i, "codebook": bits * 2.0 - 1.0}


def export_tokenizer_state(
    variables: Any, codebook_size: Optional[int] = None
) -> Dict[str, np.ndarray]:
    """Flax ConvVQModel params -> reference ConvVQModel state dict.

    LFQ tokenizers have no quantizer parameters (embedding-free), so their
    state-dict buffers must be reconstructed — pass `codebook_size`
    (config `model.vq_model.codebook_size`). VQ tokenizers carry their
    codebook as `quantize/embedding` and need no extra argument.
    """
    params = variables.get("params", variables)
    flat = _flatten(params)
    state: Dict[str, np.ndarray] = {}
    has_vq_embedding = False
    for path, value in flat.items():
        leaf = path[-1]
        base = ".".join(_unmerge(p) for p in path[:-1])
        if leaf == "embedding":
            # stored AT quantize/embedding by the importer
            state[".".join(_unmerge(p) for p in path) + ".weight"] = value
            has_vq_embedding = True
        elif leaf == "kernel":
            if value.ndim == 4:  # HWIO -> OIHW
                value = value.transpose(3, 2, 0, 1)
            elif value.ndim == 2:
                value = value.T
            state[base + ".weight"] = value
        elif leaf == "scale":
            state[base + ".weight"] = value
        elif leaf == "bias":
            state[base + ".bias"] = value
        else:
            raise ValueError(f"Unrecognized tokenizer param {'/'.join(path)!r}")
    if not has_vq_embedding:
        if codebook_size is None:
            raise ValueError(
                "LFQ tokenizer export needs codebook_size to reconstruct "
                "the quantize.{bits_to_indices,codebook} buffers"
            )
        for name, buf in _lfq_buffers(codebook_size).items():
            state[f"quantize.{name}"] = buf
    return state


_LAYER_RE = re.compile(r"^layers_(\d+)_(attn|ffn)$")
_NORM_LEAF = {"scale": "weight", "bias": "bias"}


def _derive_splits(bits: int, out_features: int) -> int:
    """codebook_splits from prediction_layer's out = splits * 2^(bits/splits)."""
    matches = [
        s for s in range(1, bits + 1)
        if bits % s == 0 and s * 2 ** (bits // s) == out_features
    ]
    if len(matches) != 1:
        raise ValueError(
            f"codebook_splits is ambiguous for bits={bits}, "
            f"out={out_features} (candidates {matches}) — pass it explicitly"
        )
    return matches[0]


def export_generator_state(
    variables: Any, codebook_splits: Optional[int] = None
) -> Dict[str, np.ndarray]:
    """Flax Bert/LFQBert params -> reference Bert/LFQBert state dict.

    LFQBert's `bits_to_indices` buffer is reconstructed from the projection
    shapes; pass `codebook_splits` if the shape-derived value is ambiguous
    (tiny test configs only — every published config derives uniquely).
    """
    params = variables.get("params", variables)
    flat = _flatten(params)
    state: Dict[str, np.ndarray] = {}
    for path, value in flat.items():
        if path == ("pos_emb",):
            state["pos_emb"] = value
        elif path == ("class_emb", "embedding"):
            state["class_emb.weight"] = value
        elif (len(path) == 2 and path[0].startswith("tok_emb_")
              and path[1] == "embedding"):
            state[f"tok_emb_list.{path[0][len('tok_emb_'):]}.weight"] = value
        elif len(path) == 1 and re.fullmatch(r"bias_\d+", path[0]):
            state[f"bias.{path[0].split('_')[1]}"] = value
        elif path[0] == "first_norm":
            state[f"first_layer.0.{_NORM_LEAF[path[1]]}"] = value
        elif path[0] == "norm_after_transformer":
            state[f"norm_after_transformer.{_NORM_LEAF[path[1]]}"] = value
        elif path[0] == "last_norm":
            state[f"last_layer.2.{_NORM_LEAF[path[1]]}"] = value
        elif path[0] == "last_dense":
            if path[1] == "kernel":
                state["last_layer.0.weight"] = value.T
            else:
                state["last_layer.0.bias"] = value
        elif path[0] in ("input_proj", "prediction_layer"):
            if path[1] == "kernel":
                state[f"{path[0]}.weight"] = value.T
            else:
                state[f"{path[0]}.bias"] = value
        elif path[0] == "transformer" and (m := _LAYER_RE.match(path[1])):
            i, kind = m.group(1), m.group(2)
            rest = path[2:]
            if kind == "attn":
                base = f"transformer.layers.{i}.0"
                if rest == ("mha", "qkv", "kernel"):
                    state[f"{base}.mha.in_proj_weight"] = value.T
                elif rest == ("mha", "qkv", "bias"):
                    state[f"{base}.mha.in_proj_bias"] = value
                elif rest == ("mha", "out_proj", "kernel"):
                    state[f"{base}.mha.out_proj.weight"] = value.T
                elif rest == ("mha", "out_proj", "bias"):
                    state[f"{base}.mha.out_proj.bias"] = value
                elif rest[0] == "norm":
                    state[f"{base}.norm.{_NORM_LEAF[rest[1]]}"] = value
                else:
                    raise ValueError(
                        f"Unrecognized attention param {'/'.join(path)!r}")
            else:
                base = f"transformer.layers.{i}.1"
                if rest[0] in ("fc1", "fc2"):
                    net_idx = "0" if rest[0] == "fc1" else "2"
                    if rest[1] == "kernel":
                        state[f"{base}.net.{net_idx}.weight"] = value.T
                    else:
                        state[f"{base}.net.{net_idx}.bias"] = value
                elif rest[0] == "norm":
                    state[f"{base}.norm.{_NORM_LEAF[rest[1]]}"] = value
                else:
                    raise ValueError(
                        f"Unrecognized ffn param {'/'.join(path)!r}")
        else:
            raise ValueError(f"Unrecognized generator param {'/'.join(path)!r}")

    if ("input_proj", "kernel") in flat:  # LFQBert (embedding-free)
        bits = int(flat[("input_proj", "kernel")].shape[0])
        out_features = int(flat[("prediction_layer", "kernel")].shape[1])
        splits = (codebook_splits if codebook_splits is not None
                  else _derive_splits(bits, out_features))
        effective_bits = bits // splits
        if splits * 2**effective_bits != out_features:
            raise ValueError(
                f"codebook_splits={splits} inconsistent with shapes "
                f"(bits={bits}, prediction out={out_features})")
        state["bits_to_indices"] = (
            2 ** np.arange(effective_bits, dtype=np.int64)).astype(np.int32)
    return state
