"""Pre-tokenize an image shard set with a frozen Stage-I tokenizer.

    python -m maskbit_tpu_torch.cli.pretokenize config=configs/tokenizer/maskbit_tokenizer_14bit.yaml \\
        experiment.vqgan_checkpoint=/ckpts/maskbit_tokenizer_14bit.bin \\
        pretokenize.shards='/data/imagenet-train-{0000..0252}.tar' \\
        pretokenize.output='/data/tokens/train-%04d.npz'

then train Stage-II from the tokens:

    python -m maskbit_tpu_torch.cli.train_maskbit config=... \\
        dataset.params.token_shards_path_or_url='/data/tokens/train-{0000..0025}.npz'

Counterpart of `maskbit_tpu/cli/pretokenize.py`: the same keys
(`pretokenize.shards`, default the train shards; `.output`, `.batch_size`
64, `.max_samples` 0 = all, `.shard_size` 50000, `.train_augmentation`
true), the same transforms, and shards in the same `.npz` format.
`pretokenize.device` (default "cuda") names the device; CUDA requested and
absent is an error. The tokenizer runs in `training.mixed_precision`
(default float32). Without a checkpoint its weights are seeded random ones
(smoke mode, with a warning).
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Iterable, Optional

import torch

from maskbit_tpu_torch.cli.common import (
    build_tokenizer,
    compute_dtype,
    resolve_device,
)
from maskbit_tpu_torch.core.config import config_from_cli
from maskbit_tpu_torch.data.tar_reader import TarImageDataset, batched
from maskbit_tpu_torch.data.token_shards import TokenShardWriter
from maskbit_tpu_torch.data.transforms import EvalTransform, TrainTransform
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from maskbit_tpu_torch.utils.logger import setup_logger


def tokenize_to_shards(tokenizer: ConvVQModel, batches: Iterable[dict],
                       writer: TokenShardWriter, device, max_samples: int = 0,
                       logger: Optional[logging.Logger] = None) -> int:
    """Tokenize {'image': (b, H, W, 3) float32 in [0, 1], 'class_id': (b,)}
    numpy batches on `device` into `writer`, then close it; stop after the
    batch that reaches `max_samples` (0: all). Returns the samples written."""
    tokenizer.eval()
    logged = 0
    for batch in batches:
        images = torch.from_numpy(batch["image"]).to(device)
        with torch.inference_mode():
            tokens = tokenizer.tokenize(images).reshape(images.shape[0], -1)
        writer.write_batch(tokens.cpu().numpy(), batch["class_id"])
        if logger is not None and writer.total - logged >= 50 * len(images):
            logged = writer.total
            logger.info(f"tokenized {writer.total} images")
        if max_samples and writer.total >= max_samples:
            break
    writer.close()
    return writer.total


def main(argv=None) -> int:
    config = config_from_cli(argv if argv is not None else sys.argv[1:])
    logger = setup_logger("maskbit_tpu_torch.pretokenize")
    device = resolve_device(config, "pretokenize.device")
    output_dir = os.path.join(os.environ.get("WORKSPACE", "./workspace"),
                              config.select("experiment.name", "run"), "pretokenize")
    os.makedirs(output_dir, exist_ok=True)
    config.save_yaml(os.path.join(output_dir, "config.yaml"))

    tokenizer = build_tokenizer(config, logger, device, compute_dtype(config, default="no"))

    res = config.select("dataset.preprocessing.resolution", 256)
    prep = config.dataset.preprocessing
    if config.select("pretokenize.train_augmentation", True):
        transform = TrainTransform(
            resolution=res, min_scale=prep.get("min_scale", 0.8),
            use_aspect_ratio_aug=prep.get("use_aspect_ratio_aug", False),
            use_random_crop=prep.get("use_random_crop", True),
            interpolation=prep.get("interpolation", "bicubic"),
            seed=config.select("training.seed", 42))
    else:
        transform = EvalTransform(resolution=res,
                                  interpolation=prep.get("interpolation", "bicubic"))

    shards = config.select("pretokenize.shards",
                           config.select("dataset.params.train_shards_path_or_url", ""))
    output = config.select("pretokenize.output", "tokens/train-%04d.npz")
    batch_size = config.select("pretokenize.batch_size", 64)
    dataset = TarImageDataset(shards, transform, resample=False)
    writer = TokenShardWriter(output, maxcount=config.select("pretokenize.shard_size", 50_000))
    total = tokenize_to_shards(tokenizer, batched(iter(dataset), batch_size, drop_last=False),
                               writer, device, config.select("pretokenize.max_samples", 0),
                               logger)
    logger.info(f"wrote {total} tokenized samples to {output}")
    return total


if __name__ == "__main__":
    main()
