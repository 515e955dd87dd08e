"""Parameter trees of the JAX package -> the original repo's state dicts.

The port's own copy (numpy only) of the exporters in
`maskbit_tpu/compat/torch_export.py`: JAX (flax) parameter trees, given as
nested mappings of numpy arrays, become state dicts in the original repo's
layout, with the deterministic registered buffers rebuilt (LFQ
`quantize.bits_to_indices` / `quantize.codebook`, LFQBert
`bits_to_indices`). Every tokenizer parameter is exported, the encoder's
included (a VQ tokenizer's codebook as `quantize.embedding.weight`). Renames
and transposes: HWIO -> OIHW, packed qkv -> `in_proj_weight`, norm `scale`
-> `weight`. `export_inception_state` turns the JAX Inception tree into the
pt-fid / torchvision layout of `eval/inception.InceptionV3`; the Stage-I
exporters turn the discriminators' trees into the original repo's layout
and the perceptual backbones' (ResNet-50, ConvNeXt-S, LPIPS's VGG16) into
torchvision's.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Optional

import numpy as np

from maskbit_tpu_torch.nn.blur import BLUR_KERNEL_MAP, blur_kernel


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


# the CompVis mid block's children keep their underscores (`mid.block_1`)
_TAMING_MID = ("block_1", "attn_1", "block_2")


def _torch_key(path: tuple) -> str:
    """A flax module path -> the dotted torch module name."""
    return ".".join(p if i and path[i - 1] == "mid" and p in _TAMING_MID else _unmerge(p)
                    for i, p in enumerate(path))


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
    """Flax ConvVQModel or taming OriginalVQModel params -> the original
    repo's (or CompVis's) state dict.

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
        base = _torch_key(path[:-1])
        if leaf == "embedding":
            # stored AT quantize/embedding by the importer
            state[_torch_key(path) + ".weight"] = value
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


_BN_LEAF = {"bn_scale": "weight", "bn_bias": "bias", "bn_mean": "running_mean",
            "bn_var": "running_var"}


def export_inception_state(variables: Any) -> Dict[str, np.ndarray]:
    """Flax InceptionV3 params (`maskbit_tpu/eval/inception.py`) -> the
    pt-fid / torchvision `inception_v3` state dict: `X.conv.weight` (OIHW),
    `X.bn.{weight,bias,running_mean,running_var,num_batches_tracked}`,
    `fc.weight` = fc_kernel.T and a zero `fc.bias` (the Flax tree has none:
    'logits_unbiased' does not use it)."""
    params = variables.get("params", variables)
    state: Dict[str, np.ndarray] = {}
    for path, value in _flatten(params).items():
        if path == ("fc_kernel",):
            state["fc.weight"] = value.T
            state["fc.bias"] = np.zeros(value.shape[1], value.dtype)
            continue
        base = ".".join(path[:-1])
        if path[-2:] == ("conv", "kernel"):
            state[f"{base}.weight"] = value.transpose(3, 2, 0, 1)
        elif path[-1] in _BN_LEAF:
            state[f"{base}.bn.{_BN_LEAF[path[-1]]}"] = value
            state[f"{base}.bn.num_batches_tracked"] = np.zeros((), np.int64)
        else:
            raise ValueError(f"Unrecognized inception param {'/'.join(path)!r}")
    return state


def _oihw(kernel: np.ndarray) -> np.ndarray:
    return kernel.transpose(3, 2, 0, 1)


def _conv_entries(node: Any, base: str) -> Dict[str, np.ndarray]:
    """A flax Conv/Dense node -> `{base}.weight` (OIHW or (out, in)) and
    `{base}.bias` where it has one."""
    kernel = np.asarray(node["kernel"])
    out = {f"{base}.weight": _oihw(kernel) if kernel.ndim == 4 else kernel.T}
    if "bias" in node:
        out[f"{base}.bias"] = np.asarray(node["bias"])
    return out


def _norm_entries(node: Any, base: str) -> Dict[str, np.ndarray]:
    return {f"{base}.weight": np.asarray(node["scale"]), f"{base}.bias": np.asarray(node["bias"])}


def export_discriminator_state(variables: Any, blur_kernel_size: Optional[int] = None
                               ) -> Dict[str, np.ndarray]:
    """Flax `NLayerDiscriminatorv2` or `OriginalNLayerDiscriminator` params
    -> the original repo's state dict (inverse of the JAX package's
    `convert_discriminator_state` and `convert_original_discriminator_state`).
    The v2 blur's buffers `blocks.{i}.1.kernel` are rebuilt when
    `blur_kernel_size` is given; the Pix2Pix BatchNorm's running statistics
    (never read in training) are rebuilt as zeros and ones."""
    params = variables.get("params", variables)
    state: Dict[str, np.ndarray] = {}
    if "block_in_conv" in params:
        stages = sorted(int(k.split("_")[1]) for k in params if k.endswith("_conv")
                        and k.startswith("block_") and k != "block_in_conv")
        state.update(_conv_entries(params["block_in_conv"], "block_in.0"))
        for i in stages:
            state.update(_conv_entries(params[f"block_{i}_conv"], f"blocks.{i}.0"))
            if blur_kernel_size is not None:
                state[f"blocks.{i}.1.kernel"] = blur_kernel(BLUR_KERNEL_MAP[blur_kernel_size])
            state.update(_norm_entries(params[f"block_{i}_norm"], f"blocks.{i}.2"))
        state.update(_conv_entries(params["to_logits_conv1"], "to_logits.0"))
        state.update(_conv_entries(params["to_logits_conv2"], "to_logits.2"))
        return state
    num_stages = max(int(k.split("_")[1]) for k in params if k.startswith("bn_"))
    state.update(_conv_entries(params["conv_0"], "main.0"))
    idx = 2
    for n in range(1, num_stages + 1):
        state.update(_conv_entries(params[f"conv_{n}"], f"main.{idx}"))
        bn = params[f"bn_{n}"]
        state.update(_norm_entries(bn, f"main.{idx + 1}"))
        width = np.asarray(bn["scale"]).shape[0]
        state[f"main.{idx + 1}.running_mean"] = np.zeros(width, np.float32)
        state[f"main.{idx + 1}.running_var"] = np.ones(width, np.float32)
        state[f"main.{idx + 1}.num_batches_tracked"] = np.zeros((), np.int64)
        idx += 3
    state.update(_conv_entries(params["conv_out"], f"main.{idx}"))
    return state


def _bn_entries(node: Any, base: str) -> Dict[str, np.ndarray]:
    """A flax `FrozenBatchNorm` node -> torchvision BatchNorm2d entries."""
    out = _norm_entries(node, base)
    out[f"{base}.running_mean"] = np.asarray(node["mean"])
    out[f"{base}.running_var"] = np.asarray(node["var"])
    out[f"{base}.num_batches_tracked"] = np.zeros((), np.int64)
    return out


def export_resnet50_state(variables: Any) -> Dict[str, np.ndarray]:
    """The JAX package's perceptual ResNet-50 params (`model/...`) ->
    torchvision's `resnet50` state dict (inverse of its
    `convert_resnet50_state`)."""
    params = variables.get("params", variables)
    params = params.get("model", params)
    state = _conv_entries(params["conv1"], "conv1")
    state.update(_bn_entries(params["bn1"], "bn1"))
    for stage, num_blocks in enumerate((3, 4, 6, 3)):
        for block in range(num_blocks):
            node, base = params[f"layer{stage + 1}_{block}"], f"layer{stage + 1}.{block}"
            for i in (1, 2, 3):
                state.update(_conv_entries(node[f"conv{i}"], f"{base}.conv{i}"))
                state.update(_bn_entries(node[f"bn{i}"], f"{base}.bn{i}"))
            if "downsample_conv" in node:
                state.update(_conv_entries(node["downsample_conv"], f"{base}.downsample.0"))
                state.update(_bn_entries(node["downsample_bn"], f"{base}.downsample.1"))
    state.update(_conv_entries(params["fc"], "fc"))
    return state


def export_convnext_small_state(variables: Any) -> Dict[str, np.ndarray]:
    """The JAX package's ConvNeXt-S params (`model/...`) -> torchvision's
    `convnext_small` state dict (inverse of its `convert_convnext_small_state`)."""
    params = variables.get("params", variables)
    params = params.get("model", params)
    state = _conv_entries(params["stem_conv"], "features.0.0")
    state.update(_norm_entries(params["stem_norm"], "features.0.1"))
    for stage in range(4):
        tv = 1 + 2 * stage
        if stage > 0:
            state.update(_norm_entries(params[f"down{stage}_norm"], f"features.{tv - 1}.0"))
            state.update(_conv_entries(params[f"down{stage}_conv"], f"features.{tv - 1}.1"))
        block = 0
        while f"stage{stage}_block{block}" in params:
            node, base = params[f"stage{stage}_block{block}"], f"features.{tv}.{block}"
            state.update(_conv_entries(node["dwconv"], f"{base}.block.0"))
            state.update(_norm_entries(node["norm"], f"{base}.block.2"))
            state.update(_conv_entries(node["pw1"], f"{base}.block.3"))
            state.update(_conv_entries(node["pw2"], f"{base}.block.5"))
            state[f"{base}.layer_scale"] = np.asarray(node["layer_scale"]).reshape(-1, 1, 1)
            block += 1
    state.update(_norm_entries(params["head_norm"], "classifier.0"))
    state.update(_conv_entries(params["head_fc"], "classifier.2"))
    return state


# torchvision vgg16 `features` index of each of the 13 convolutions
_VGG16_CONV_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def export_vgg16_state(net: Any) -> Dict[str, np.ndarray]:
    """The JAX package's LPIPS `net` node (`conv_{0..12}`) -> torchvision's
    `vgg16` `features.{i}` entries."""
    state: Dict[str, np.ndarray] = {}
    for ordinal, index in enumerate(_VGG16_CONV_INDEX):
        state.update(_conv_entries(net[f"conv_{ordinal}"], f"features.{index}"))
    return state
