"""Inference demo: load the two models, sample class-conditional images, save a grid.

    python -m maskbit_tpu_torch.cli.demo config=configs/demo/demo.yaml \\
        demo.labels=[1,7,282] demo.output=samples.png demo.device=cuda

Counterpart of `maskbit_tpu/cli/demo.py` (the original repo's demo_utils):
`get_tokenizer` and `get_generator` (a `.bin` checkpoint, else seeded random
weights), `sample` (the masked CFG sampler, NHWC in [0, 1]),
`visualize_reconstruction` (original | reconstruction | difference, through
the tokenizer's forward) and `imagenet_classname`, with the port's own copy
of the ImageNet class names. The models compute in `training.mixed_precision`
(default bf16, which the attention block kernel needs on the card; the JAX
demo computes in float32). `demo.device` (default "cuda") names the device.
"""

from __future__ import annotations

import json
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from maskbit_tpu_torch.cli.common import (
    build_module,
    compute_dtype,
    random_init_,
    resolve_device,
)
from maskbit_tpu_torch.core.checkpoint import load_pretrained
from maskbit_tpu_torch.core.config import config_from_cli
from maskbit_tpu_torch.models.generator import make_generator
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from maskbit_tpu_torch.sampling.sample import SamplingConfig, default_labels, make_sampler
from maskbit_tpu_torch.utils.viz import (
    make_viz_from_samples,
    make_viz_generated_stage_two,
    save_image_grid,
)

_CLASSNAMES_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "data", "imagenet_classnames.json")


def imagenet_classname(idx: int) -> str:
    with open(_CLASSNAMES_PATH) as f:
        return json.load(f)[str(int(idx))]


def _load(model, path: str, device, seed: int):
    if path and os.path.exists(path):
        model.load_state_dict(load_pretrained(path, device), strict=True)
    else:
        random_init_(model, torch.Generator(device=device).manual_seed(seed))
    return model


def get_tokenizer(config, checkpoint_path: Optional[str] = None, device="cuda",
                  dtype: Optional[torch.dtype] = None) -> ConvVQModel:
    """The Stage-I tokenizer from `checkpoint_path` or
    `experiment.vqgan_checkpoint`, eval mode on `device`."""
    dtype = dtype or compute_dtype(config)
    model = build_module(lambda: ConvVQModel.from_config(config.model.vq_model, dtype=dtype),
                         device)
    path = checkpoint_path or config.select("experiment.vqgan_checkpoint", "")
    return _load(model, path, device, seed=0)


def get_generator(config, checkpoint_path: Optional[str] = None, device="cuda",
                  dtype: Optional[torch.dtype] = None):
    """The Stage-II generator from `checkpoint_path` or
    `experiment.generator_checkpoint` (old `token_emb.*` keys load as
    `input_proj.*`), eval mode on `device`."""
    dtype = dtype or compute_dtype(config)
    mlm_cfg = config.model.mlm_model
    model = build_module(lambda: make_generator(mlm_cfg.get("model_cls", "lfq_bert"), mlm_cfg,
                                                config.model.vq_model, dtype=dtype), device)
    path = checkpoint_path or config.select("experiment.generator_checkpoint", "")
    return _load(model, path, device, seed=1)


def sample(config, generator, tokenizer, labels: Optional[List[int]] = None,
           num_samples: int = 10, seed: int = 0):
    """(images NHWC float32 in [0, 1] on the host, labels): `labels`, or the
    demo's label cycle for `num_samples`."""
    res = config.select("dataset.preprocessing.resolution", 256)
    cfg = SamplingConfig.from_config(config.model.mlm_model, config.model.vq_model)._replace(
        patch_size=res // 2 ** (config.select("model.vq_model.num_resolutions", 5) - 1))
    device = next(generator.parameters()).device
    rng = torch.Generator(device=device).manual_seed(seed)
    if labels is None:
        y = default_labels(num_samples, torch.Generator().manual_seed(seed))
    else:
        y = torch.as_tensor(labels, dtype=torch.int32)
    images, _ = make_sampler(generator, tokenizer, cfg)(y.to(device), rng)
    return images.clamp(0.0, 1.0).float().cpu().numpy(), y.numpy()


def visualize_reconstruction(tokenizer, images: np.ndarray) -> np.ndarray:
    """original | reconstruction | difference strips, one a row (uint8)."""
    device = next(tokenizer.parameters()).device
    with torch.inference_mode():
        recons, _ = tokenizer(torch.from_numpy(np.asarray(images, np.float32)).to(device))
    return make_viz_from_samples(images, recons.clamp(0, 1).float().cpu().numpy())[1]


def main(argv=None) -> str:
    """Sample, save the grid to `demo.output`; returns its path."""
    config = config_from_cli(argv if argv is not None else sys.argv[1:])
    device = resolve_device(config, "demo.device")
    tokenizer = get_tokenizer(config, device=device)
    generator = get_generator(config, device=device)
    labels = config.select("demo.labels", None)
    num = config.select("demo.num_samples", 10)
    images, y = sample(config, generator, tokenizer, labels=list(labels) if labels else None,
                       num_samples=num)
    out = config.select("demo.output", "samples.png")
    save_image_grid(make_viz_generated_stage_two(images)[1], out)
    names = [imagenet_classname(int(i)) for i in y]
    print(f"wrote {out} with classes: {names}")
    return out


if __name__ == "__main__":
    main()
