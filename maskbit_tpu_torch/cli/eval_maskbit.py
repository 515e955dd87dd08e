"""ADM-protocol generation evaluation, the headline gFID (PyTorch, one device).

    python -m maskbit_tpu_torch.cli.eval_maskbit \\
        config=configs/generator/maskbit_generator_14bit.yaml \\
        experiment.vqgan_checkpoint=... experiment.generator_checkpoint=... \\
        eval.stats_path=metrics/stats/train_imagenet256_stats.npz eval.device=cuda

Counterpart of `maskbit_tpu/cli/eval_maskbit.py` in one process:
  * class-balanced labels: `np.random.default_rng(training.seed)
    .permutation(1000)` tiled to `eval.total_samples` (numpy on both
    sides, so the labels equal the JAX package's);
  * batches of `eval.batch_size` through the masked CFG sampler (every
    attention layer of every step through the attention block kernel on the
    card); the last batch is padded with class 0 to the full batch and the
    padded rows never reach the accumulator, so exactly
    `eval.total_samples` are scored;
  * the images' uint8 truncation `floor(clip(x, 0, 1) * 255)`, computed in
    the dtype the decoder gives (bf16 under `mixed_precision: bf16`, as in
    JAX), then InceptionV3 and `AdmMomentAccumulator` (float64 moments);
  * the Inception Score, and FID against `eval.stats_path` when it exists.
Without Inception weights (`MASKBIT_INCEPTION_WEIGHTS` / `MASKBIT_ADM_PB`)
the samples are generated and no metric is computed. Weights: the two
checkpoints (`.bin`), else seeded random weights with a warning, stored in
float32 and computed in the configured dtype. The sampler's random stream
(a `torch.Generator` seeded with `training.seed`) differs from the JAX
package's. The sharded multi-device sampler and the merge across processes
wait for the runtime slice (ROADMAP.md, Queue 1 item 4).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from maskbit_tpu_torch.cli.common import (
    load_generation_models,
    resolve_device,
    setup_experiment,
    validate_generator_config,
)
from maskbit_tpu_torch.cli.eval_tokenizer import make_inception_fn
from maskbit_tpu_torch.core.config import config_from_cli
from maskbit_tpu_torch.eval.adm import AdmMomentAccumulator, Evaluator
from maskbit_tpu_torch.sampling.sample import make_sampler


def class_balanced_labels(total_samples: int, seed: int) -> np.ndarray:
    """randperm(1000) tiled to `total_samples` (the original's protocol)."""
    labels = np.random.default_rng(seed).permutation(1000).astype(np.int32)
    return np.tile(labels, int(np.ceil(total_samples / 1000)))[:total_samples]


def to_pixels_255(images: torch.Tensor) -> torch.Tensor:
    """floor(clip(x, 0, 1) * 255) in the images' dtype: the uint8 samples
    the gFID protocol scores, as floats."""
    return torch.floor(images.clamp(0.0, 1.0) * 255.0)


def _sync(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def main(argv=None) -> dict:
    """Generate and score; returns {"results": the metrics (also printed and
    written to eval_results.json), "count": samples scored (None without
    Inception weights), "batch_seconds": per batch {"sampler",
    "inception", "moments"} seconds (host clock, the card synchronised
    between phases), "output_dir"}."""
    config = config_from_cli(argv if argv is not None else sys.argv[1:])
    validate_generator_config(config)
    ctx = setup_experiment(config, subdir="eval_generation")
    logger = ctx["logger"]
    device = resolve_device(config, "eval.device")
    vq_cfg, mlm_cfg = config.model.vq_model, config.model.mlm_model

    tokenizer, generator, sampling_cfg, _, _ = load_generation_models(config, logger, device)
    sampler = make_sampler(generator, tokenizer, sampling_cfg)
    batch_size = int(config.select("eval.batch_size", 100))
    total_samples = int(config.select("eval.total_samples", 50_000))
    seed = ctx["seed"]
    labels = class_balanced_labels(total_samples, seed)
    num_batches = int(np.ceil(len(labels) / batch_size))

    inception_fn = make_inception_fn(device)
    evaluator = Evaluator(inception_fn) if inception_fn is not None else None
    if evaluator is None:
        logger.warning("MASKBIT_INCEPTION_WEIGHTS not set — generating samples but "
                       "skipping FID/IS computation")
    accum = AdmMomentAccumulator(total_samples=total_samples) if evaluator else None
    rng = torch.Generator(device=device).manual_seed(seed)
    logger.info(f"generating {len(labels)} samples in {num_batches} batches of {batch_size}")
    batch_seconds = []
    for i in range(num_batches):
        chunk = labels[i * batch_size:(i + 1) * batch_size]
        valid = len(chunk)
        y = np.zeros((batch_size,), np.int64)
        y[:valid] = chunk  # pad rows sample class 0 and are discarded below
        t0 = _sync(device)
        images, _ = sampler(torch.from_numpy(y).to(device), rng)
        t1 = _sync(device)
        times = {"sampler": t1 - t0}
        if accum is not None:
            feats = inception_fn(to_pixels_255(images))
            t2 = _sync(device)
            acts, logits = (feats[k][:valid].cpu().numpy() for k in ("2048", "logits_unbiased"))
            accum.update(acts, logits, np.arange(i * batch_size, i * batch_size + valid))
            times.update(inception=t2 - t1, moments=time.perf_counter() - t2)
        batch_seconds.append(times)
        if (i + 1) % 10 == 0:
            logger.info(f"generated {min((i + 1) * batch_size, len(labels))} samples")

    results = {}
    if accum is not None:
        accum.merge_across_hosts()
        if accum.count != total_samples:
            raise RuntimeError(f"accumulated {accum.count} != eval.total_samples {total_samples}")
        results["InceptionScore"] = accum.inception_score()
        stats_path = config.select("eval.stats_path", "")
        if stats_path and os.path.exists(stats_path):
            ref_stats = evaluator.read_statistics(stats_path, None)
            results["FID"] = accum.fid_statistics().frechet_distance(ref_stats)
        else:
            logger.warning(f"eval.stats_path {stats_path!r} missing — FID skipped")

    logger.info(f"Results for {vq_cfg.get('token_size')} bits with "
                f"{mlm_cfg.get('num_steps')} steps: {results}")
    print(json.dumps(results))
    with open(os.path.join(ctx["output_dir"], "eval_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return {"results": results, "count": accum.count if accum is not None else None,
            "batch_seconds": batch_seconds, "output_dir": ctx["output_dir"]}


if __name__ == "__main__":
    main()
