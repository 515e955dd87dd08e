"""Shared plumbing for the port's entry points.

Counterpart of `maskbit_tpu/cli/common.py`'s `validate_generator_config`,
`load_generation_models`, `synthetic_batches`, the synthetic branch of
`build_dataloaders`, and `StepTimer`.
"""

from __future__ import annotations

import math
import os
import re
import time
from typing import Callable, Iterator, List

import numpy as np
import torch
from torch import nn

from maskbit_tpu_torch.core.checkpoint import load_pretrained
from maskbit_tpu_torch.models.generator import make_generator
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from maskbit_tpu_torch.sampling.sample import SamplingConfig


def validate_generator_config(config) -> None:
    """Fail fast on inconsistent token geometry."""
    vq = config.model.vq_model
    mlm = config.model.mlm_model
    codebook_size = vq.get("codebook_size", 1024)
    bits = int(math.log2(codebook_size))
    if 2**bits != codebook_size:
        raise ValueError(f"codebook_size {codebook_size} is not a power of two")
    if vq.get("quantizer_type", "lookup-free") == "lookup-free" and vq.get("token_size") != bits:
        raise ValueError(
            f"lookup-free tokenizer: token_size {vq.get('token_size')} must equal "
            f"log2(codebook_size) = {bits}")
    splits = mlm.get("codebook_splits", 1)
    if bits % splits != 0:
        raise ValueError(f"codebook_splits {splits} must divide token bits {bits}")
    res = config.select("dataset.preprocessing.resolution", 256)
    stride = mlm.get("input_stride", 16)
    tok_stride = 2 ** (vq.get("num_resolutions", 5) - 1)
    if stride != tok_stride:
        raise ValueError(
            f"mlm_model.input_stride {stride} must match the tokenizer downsample "
            f"factor 2^(num_resolutions-1) = {tok_stride}")
    if mlm.get("img_size", 256) != res:
        raise ValueError(
            f"mlm_model.img_size {mlm.get('img_size', 256)} must match "
            f"dataset resolution {res}")


def compute_dtype(config, default: str = "bf16") -> torch.dtype:
    """`training.mixed_precision` as a dtype; the generation entry points
    default to bf16, the trainer (as the JAX trainer) to float32."""
    mp = config.select("training.mixed_precision", default)
    return torch.bfloat16 if mp in ("bf16", "bfloat16") else torch.float32


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights for smoke runs: matrices and conv kernels
    N(0, 1/fan_in), norm scales 1, every other parameter (biases,
    embeddings, `pos_emb`) N(0, 0.02^2); buffers rebuilt."""
    for name, p in module.named_parameters():
        if p.dim() == 1 and name.endswith(".weight") and _is_norm(module, name):
            p.fill_(1.0)
        elif p.dim() == 1 or "emb" in name:
            p.normal_(0.0, 0.02, generator=generator)
        else:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
    for m in module.modules():
        if hasattr(m, "reset_buffers"):
            m.reset_buffers()


def _is_norm(root: nn.Module, param_name: str) -> bool:
    owner = root.get_submodule(param_name.rsplit(".", 1)[0])
    return isinstance(owner, (nn.LayerNorm, nn.GroupNorm))


def build_module(ctor, device) -> nn.Module:
    """Construct without drawing from the global RNG, then allocate on device."""
    with torch.device("meta"):
        module = ctor()
    return module.to_empty(device=device).eval()


def load_generation_models(config, logger, device, cast_weights: bool = False):
    """Checkpoint-or-random loading for the generation entry points: returns
    (tokenizer, generator, sampling_cfg, res, dtype), both models in eval
    mode on `device`.

    Without a checkpoint the weights are a seeded random init (seed
    `training.seed`), with a warning. cast_weights: store the weights in the
    compute dtype (serving); the attention block upcasts its biases and norm
    parameters to float32 itself."""
    vq_cfg = config.model.vq_model
    mlm_cfg = config.model.mlm_model
    dtype = compute_dtype(config)
    device = torch.device(device)
    seed = int(config.select("training.seed", 42))

    tokenizer = build_module(lambda: ConvVQModel.from_config(vq_cfg, dtype=dtype), device)
    generator = build_module(lambda: make_generator(mlm_cfg.get("model_cls", "lfq_bert"),
                                              mlm_cfg, vq_cfg, dtype=dtype), device)
    res = config.select("dataset.preprocessing.resolution", 256)

    for what, model, key, offset in (("tokenizer", tokenizer, "experiment.vqgan_checkpoint", 0),
                                     ("generator", generator,
                                      "experiment.generator_checkpoint", 1)):
        path = config.select(key, "")
        if path and os.path.exists(path):
            model.load_state_dict(load_pretrained(path, device), strict=True)
        else:
            logger.warning(f"{what} checkpoint missing — RANDOM weights (smoke mode)")
            random_init_(model, torch.Generator(device=device).manual_seed(seed + offset))
    if cast_weights and dtype != torch.float32:
        tokenizer.to(dtype)
        generator.to(dtype)

    sampling_cfg = SamplingConfig.from_config(mlm_cfg, vq_cfg)._replace(
        patch_size=res // 2 ** (vq_cfg.get("num_resolutions", 5) - 1))
    return tokenizer, generator, sampling_cfg, res, dtype


_BRACE_RE = re.compile(r"^(.*)\{(\d+)\.\.(\d+)\}(.*)$")


def expand_shard_pattern(pattern: str) -> List[str]:
    """'imagenet-train-{0000..0252}.tar' -> the shard list; a plain path or
    a glob also works (as in `maskbit_tpu.data.tar_reader`)."""
    m = _BRACE_RE.match(pattern)
    if m:
        prefix, lo, hi, suffix = m.groups()
        return [f"{prefix}{i:0{len(lo)}d}{suffix}" for i in range(int(lo), int(hi) + 1)]
    if any(ch in pattern for ch in "*?["):
        import glob

        return sorted(glob.glob(pattern))
    return [pattern]


def synthetic_batches(batch_size: int, resolution: int, seed: int = 0) -> Iterator[dict]:
    """Random image/label batches (numpy, NHWC in [0, 1]); the same stream
    as the JAX package's for the same seed."""
    rng = np.random.default_rng(seed)
    while True:
        yield {
            "image": rng.uniform(size=(batch_size, resolution, resolution, 3)).astype(np.float32),
            "class_id": rng.integers(0, 1000, size=(batch_size,)).astype(np.int32),
        }


def build_dataloaders(config, logger, global_batch_size: int) -> Callable[[], Iterator[dict]]:
    """The train batches' iterator factory: synthetic batches when no train
    shards exist. The tar-shard reader is not ported yet: when the named
    shards exist this raises rather than train on synthetic data."""
    train_shards = config.select("dataset.params.train_shards_path_or_url", "")
    resolution = config.select("dataset.preprocessing.resolution", 256)
    expanded = expand_shard_pattern(train_shards) if train_shards else []
    if expanded and os.path.exists(expanded[0]):
        raise NotImplementedError(
            f"train shards {train_shards!r} exist, but the tar-shard reader is not ported to "
            "PyTorch yet (ROADMAP.md, Queue 1: the tar-shard reader)")
    logger.warning(f"Train shards {train_shards!r} not found — using SYNTHETIC data. "
                   "Point dataset.params.train_shards_path_or_url at real shards for training.")
    return lambda: synthetic_batches(global_batch_size, resolution, seed=0)


class AverageMeter:
    def __init__(self):
        self.val = self.sum = self.avg = 0.0
        self.count = 0

    def update(self, val: float):
        self.val = val
        self.sum += val
        self.count += 1
        self.avg = self.sum / self.count


class StepTimer:
    """samples/s bookkeeping: data and batch time meters (host clock; a
    step's time is only the device's once something waits for it)."""

    def __init__(self):
        self.batch_time = AverageMeter()
        self.data_time = AverageMeter()
        self._end = time.time()

    def data_tick(self):
        self.data_time.update(time.time() - self._end)

    def batch_tick(self):
        self.batch_time.update(time.time() - self._end)
        self._end = time.time()
