"""The original repo's state dicts -> parameter trees of the JAX package.

The port's own copy (numpy; torch tensors are taken as they come) of
`maskbit_tpu/compat/torch_convert.py`'s tokenizer and generator converters,
the inverse of `compat/torch_export.py`. `cli/convert_checkpoint` reads a
`.bin` with `core.checkpoint.load_pretrained` and writes these trees as the
JAX package's `.msgpack` zoo files. The rules:
  * `token_emb` -> `input_proj` for LFQBert checkpoints (the original
    repo's legacy name);
  * a taming checkpoint's bundled `loss.*` keys are dropped;
  * Bert's `tok_emb_list.{i}` -> `tok_emb_{i}/embedding`, `bias.{i}` ->
    `bias_{i}`;
  * torch MultiheadAttention's packed `in_proj_weight` -> the qkv kernel;
  * OIHW conv kernels -> HWIO, `weight` -> `kernel` (transposed) or norm
    `scale`, indices merged into names (`down.0` -> `down_0`);
  * the deterministic buffers are dropped.
`convert_state` picks the tokenizer or the generator converter by the
keys. The discriminator converters are not used by any entry point and are
not copied.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np


def _to_numpy(value: Any) -> np.ndarray:
    if isinstance(value, np.ndarray):
        return value
    # torch tensor (avoid importing torch unless needed)
    return value.detach().cpu().numpy()


def _set_path(tree: Dict, path: tuple, value: np.ndarray) -> None:
    node = tree
    for part in path[:-1]:
        node = node.setdefault(part, {})
    node[path[-1]] = value


def _merge_indices(key: str) -> list:
    """'encoder.down.0.res_blocks.1.conv1.weight' ->
    ['encoder', 'down_0', 'res_blocks_1', 'conv1', 'weight']."""
    parts = key.split(".")
    merged: list = []
    for part in parts:
        if part.isdigit() and merged:
            merged[-1] = f"{merged[-1]}_{part}"
        else:
            merged.append(part)
    return merged


_SKIP_SUFFIXES = ("bits_to_indices", "codebook", "num_batches_tracked", "kernel_buffer")


def convert_tokenizer_state(state: Mapping[str, np.ndarray]) -> Dict:
    """Reference ConvVQModel state dict -> flax params for models.ConvVQModel.

    Handles both `ConvDecoder` and `ConvDecoderLegacy` checkpoints — the
    naming difference (up-stage index order) is preserved verbatim, so the
    flax model must be constructed with the matching `legacy` flag.
    """
    params: Dict = {}
    for key, value in state.items():
        if key.endswith(_SKIP_SUFFIXES):
            continue
        if key.startswith("loss."):
            # taming checkpoints bundle the training loss module; drop it
            # (reference modeling/taming_vqgan.py:101-113)
            continue
        value = _to_numpy(value)
        parts = _merge_indices(key)
        leaf = parts[-1]
        module_path = tuple(parts[:-1])

        if leaf == "weight":
            if module_path and module_path[-1] == "embedding":
                # VQ codebook: quantize.embedding.weight -> quantize/embedding
                _set_path(params, module_path, value)
                continue
            if value.ndim == 4:  # conv OIHW -> HWIO
                _set_path(params, module_path + ("kernel",), value.transpose(2, 3, 1, 0))
            elif value.ndim == 2:  # linear
                _set_path(params, module_path + ("kernel",), value.T)
            else:  # norm scale
                _set_path(params, module_path + ("scale",), value)
        elif leaf == "bias":
            _set_path(params, module_path + ("bias",), value)
        else:
            raise ValueError(f"Unrecognized tokenizer key {key!r}")
    return {"params": params}


_GEN_ATTN_RE = re.compile(r"^transformer\.layers\.(\d+)\.0\.(.*)$")
_GEN_FFN_RE = re.compile(r"^transformer\.layers\.(\d+)\.1\.(.*)$")


def convert_generator_state(state: Mapping[str, np.ndarray]) -> Dict:
    """Reference Bert/LFQBert state dict -> flax params for models.generator."""
    params: Dict = {}

    def put(path_str: str, value: np.ndarray) -> None:
        _set_path(params, tuple(path_str.split("/")), value)

    for key, value in state.items():
        if key.endswith(_SKIP_SUFFIXES):
            continue
        value = _to_numpy(value)

        # legacy checkpoint rename (reference scripts/eval_maskbit.py:52)
        if key.startswith("token_emb."):
            key = "input_proj." + key[len("token_emb."):]

        if key == "pos_emb":
            put("pos_emb", value)
        elif key == "class_emb.weight":
            put("class_emb/embedding", value)
        elif key.startswith("tok_emb_list."):
            idx = key.split(".")[1]
            put(f"tok_emb_{idx}/embedding", value)
        elif re.match(r"^bias\.\d+$", key):
            idx = key.split(".")[1]
            put(f"bias_{idx}", value)
        elif key.startswith("first_layer.0."):
            leaf = "scale" if key.endswith("weight") else "bias"
            put(f"first_norm/{leaf}", value)
        elif key == "norm_after_transformer.weight":
            put("norm_after_transformer/scale", value)
        elif key == "norm_after_transformer.bias":
            put("norm_after_transformer/bias", value)
        elif key.startswith("last_layer.0."):
            if key.endswith("weight"):
                put("last_dense/kernel", value.T)
            else:
                put("last_dense/bias", value)
        elif key.startswith("last_layer.2."):
            leaf = "scale" if key.endswith("weight") else "bias"
            put(f"last_norm/{leaf}", value)
        elif key.startswith(("input_proj.", "prediction_layer.")):
            module = key.split(".")[0]
            if key.endswith("weight"):
                put(f"{module}/kernel", value.T)
            else:
                put(f"{module}/bias", value)
        elif m := _GEN_ATTN_RE.match(key):
            i, rest = m.group(1), m.group(2)
            base = f"transformer/layers_{i}_attn"
            if rest == "mha.in_proj_weight":
                put(f"{base}/mha/qkv/kernel", value.T)
            elif rest == "mha.in_proj_bias":
                put(f"{base}/mha/qkv/bias", value)
            elif rest == "mha.out_proj.weight":
                put(f"{base}/mha/out_proj/kernel", value.T)
            elif rest == "mha.out_proj.bias":
                put(f"{base}/mha/out_proj/bias", value)
            elif rest == "norm.weight":
                put(f"{base}/norm/scale", value)
            elif rest == "norm.bias":
                put(f"{base}/norm/bias", value)
            else:
                raise ValueError(f"Unrecognized attention key {key!r}")
        elif m := _GEN_FFN_RE.match(key):
            i, rest = m.group(1), m.group(2)
            base = f"transformer/layers_{i}_ffn"
            if rest == "net.0.weight":
                put(f"{base}/fc1/kernel", value.T)
            elif rest == "net.0.bias":
                put(f"{base}/fc1/bias", value)
            elif rest == "net.2.weight":
                put(f"{base}/fc2/kernel", value.T)
            elif rest == "net.2.bias":
                put(f"{base}/fc2/bias", value)
            elif rest == "norm.weight":
                put(f"{base}/norm/scale", value)
            elif rest == "norm.bias":
                put(f"{base}/norm/bias", value)
            else:
                raise ValueError(f"Unrecognized ffn key {key!r}")
        else:
            raise ValueError(f"Unrecognized generator key {key!r}")
    return {"params": params}


def convert_state(state: Mapping[str, np.ndarray]) -> Dict:
    """A tokenizer's state dict (it has `encoder.` or `decoder.` keys) or a
    generator's -> its flax variables, as the JAX package's
    `load_pretrained` reads a `.bin`."""
    if any(k.startswith(("encoder.", "decoder.")) for k in state):
        return convert_tokenizer_state(state)
    return convert_generator_state(state)
