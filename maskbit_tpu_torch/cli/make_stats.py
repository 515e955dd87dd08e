"""ADM-format FID reference statistics from tar shards (PyTorch).

    MASKBIT_INCEPTION_WEIGHTS=/path/pt_inception.pth \\
    python -m maskbit_tpu_torch.cli.make_stats --shards '/data/train-{0000..0252}.tar' \\
        --output metrics/stats/train_imagenet256_stats.npz --resolution 256

Counterpart of `maskbit_tpu/cli/make_stats.py`: every image of the shards
(in order, `EvalTransform`: shorter side resized, centre crop) goes through
the port's InceptionV3 on `--device` (default cuda), and the float64 sum of
the '2048' features and of their outer products give `mu` and the unbiased
`sigma`, written as an `.npz` with keys `mu` and `sigma`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from maskbit_tpu_torch.cli.eval_tokenizer import make_inception_fn
from maskbit_tpu_torch.data.tar_reader import TarImageDataset, batched
from maskbit_tpu_torch.data.transforms import EvalTransform


def main(argv=None) -> int:
    """Write the statistics; returns the number of images."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--shards", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--resolution", type=int, default=256)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--max_samples", type=int, default=0, help="0 = all")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device is cuda but no CUDA device is available")

    inception_fn = make_inception_fn(args.device)
    if inception_fn is None:
        raise SystemExit("set MASKBIT_INCEPTION_WEIGHTS to the pt-fid weights file")

    dataset = TarImageDataset(args.shards, EvalTransform(resolution=args.resolution),
                              resample=False)
    total = np.zeros(2048, np.float64)
    outer = np.zeros((2048, 2048), np.float64)
    n = 0
    for batch in batched(iter(dataset), args.batch_size, drop_last=False):
        images = torch.from_numpy(np.asarray(batch["image"] * 255.0, np.float32))
        feats = inception_fn(images)["2048"].cpu().numpy().astype(np.float64)
        total += feats.sum(0)
        outer += feats.T @ feats
        n += feats.shape[0]
        if args.max_samples and n >= args.max_samples:
            break
        if n % (args.batch_size * 50) == 0:
            print(f"processed {n} images")

    mu = total / n
    sigma = (outer - n * np.outer(mu, mu)) / (n - 1)
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    np.savez(args.output, mu=mu, sigma=sigma)
    print(f"wrote {args.output} from {n} images")
    return n


if __name__ == "__main__":
    main()
