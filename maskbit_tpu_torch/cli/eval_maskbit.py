"""ADM-protocol generation evaluation, the headline gFID (PyTorch; the
process's cards, or one process per card under torchrun).

    python -m maskbit_tpu_torch.cli.eval_maskbit \\
        config=configs/generator/maskbit_generator_14bit.yaml \\
        experiment.vqgan_checkpoint=... experiment.generator_checkpoint=... \\
        eval.stats_path=metrics/stats/train_imagenet256_stats.npz eval.device=cuda

Counterpart of `maskbit_tpu/cli/eval_maskbit.py`:
  * class-balanced labels: `np.random.default_rng(training.seed)
    .permutation(1000)` tiled to `eval.total_samples` (numpy on both
    sides, so the labels equal the JAX package's); process p of P takes
    `labels[p::P]`, so its sample j is global sample j * P + p (the
    Inception Score's splits stay those of one process);
  * batches of `eval.batch_size` through the masked CFG sampler (every
    attention layer of every step through the attention block kernel on the
    card); each process's last batch is padded with class 0 to the full
    batch and the padded rows never reach the accumulator, so exactly
    `eval.total_samples` are scored for any process count and batch size;
  * the images' uint8 truncation `floor(clip(x, 0, 1) * 255)`, computed in
    the dtype the decoder gives (bf16 under `mixed_precision: bf16`, as in
    JAX), then InceptionV3 and `AdmMomentAccumulator` (float64 moments);
  * the moments merged over the processes (`merge_across_hosts`), then the
    Inception Score, and FID against `eval.stats_path` when it exists.
Without Inception weights (`MASKBIT_INCEPTION_WEIGHTS` / `MASKBIT_ADM_PB`)
the samples are generated and no metric is computed; every process must
agree on that, and on the stats file, or the run raises. Weights: the two
checkpoints (`.bin`), else seeded random weights with a warning, stored in
float32 and computed in the configured dtype. The sampler's random stream
(a `torch.Generator` seeded with `training.seed` plus the process index)
differs from the JAX package's. A config with `parallel.fsdp` or
`parallel.tensor` (a training config's mesh, laid out by `setup_device`)
generates the same way: data-parallel over every process, each with whole
weights. JAX's per-host clamp of those axes to its local devices (its
sharded per-host sampler mesh) has no counterpart: the port's eval splits
no weights. One process that sees several local devices
(`sampling.serve.local_devices`: every visible card for an unindexed
`eval.device=cuda`; under torchrun each process keeps its one card) splits
each batch over them (`sampling.serve.make_sharded_sampler`, a worker
process per card holding this process's weights, stopped when the run
ends), with `eval.batch_size` rounded up to a multiple of their number, as
JAX shards its per-host sampler; the padded rows are dropped as above.
`eval.shard_local_devices=false` keeps one card. The default (true, as
JAX's) follows four H100s, where a split batch of 100 ran at 1.728x the
whole batch's speed on one card over 2 cards and 2.813x over 4 (PERF.md).
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
    setup_experiment,
    validate_generator_config,
)
from maskbit_tpu_torch.cli.eval_tokenizer import make_inception_fn
from maskbit_tpu_torch.core.config import config_from_cli
from maskbit_tpu_torch.eval.adm import AdmMomentAccumulator, Evaluator
from maskbit_tpu_torch.parallel.mesh import (
    assert_host_agreement,
    is_main_process,
    process_count,
    process_index,
)
from maskbit_tpu_torch.sampling import serve as split
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
    written to eval_results.json by the main process), "count": samples
    scored over every process (None without Inception weights),
    "accumulator": the merged `AdmMomentAccumulator` (None likewise),
    "local_samples": this process's share, "batch_seconds": per batch
    {"sampler", "inception", "moments"} seconds (host clock, the card
    synchronised between phases), "output_dir"}."""
    config = config_from_cli(argv if argv is not None else sys.argv[1:])
    validate_generator_config(config)
    ctx = setup_experiment(config, subdir="eval_generation")
    logger, device = ctx["logger"], ctx["device"]
    vq_cfg, mlm_cfg = config.model.vq_model, config.model.mlm_model

    tokenizer, generator, sampling_cfg, _, _ = load_generation_models(config, logger, device)
    batch_size = int(config.select("eval.batch_size", 100))
    shard = process_count() == 1 and config.select("eval.shard_local_devices", True)
    devices = split.local_devices(device) if shard else [device]
    if len(devices) > 1:
        # one process over several cards: each batch split over them, the
        # batch rounded up to fill every shard (the pad rows are dropped)
        rounded = -(-batch_size // len(devices)) * len(devices)
        if rounded != batch_size:
            logger.info(f"eval.batch_size {batch_size} rounded up to {rounded} "
                        f"to fill {len(devices)} batch shards")
            batch_size = rounded
        logger.info(f"sharding generation batches over {len(devices)} devices")
        sampler = split.make_sharded_sampler(generator, tokenizer, sampling_cfg, devices)
    else:
        sampler = make_sampler(generator, tokenizer, sampling_cfg)
    total_samples = int(config.select("eval.total_samples", 50_000))
    seed = ctx["seed"]
    p_idx, p_cnt = process_index(), process_count()
    labels = class_balanced_labels(total_samples, seed)[p_idx::p_cnt]
    num_batches = int(np.ceil(len(labels) / batch_size))

    inception_fn = make_inception_fn(device)
    stats_path = config.select("eval.stats_path", "")
    has_stats = bool(stats_path and os.path.exists(stats_path))
    assert_host_agreement({"inception weights found": inception_fn is not None,
                           "eval.stats_path found": has_stats}, context="eval_maskbit")
    evaluator = Evaluator(inception_fn) if inception_fn is not None else None
    if evaluator is None:
        logger.warning("MASKBIT_INCEPTION_WEIGHTS not set — generating samples but "
                       "skipping FID/IS computation")
    accum = AdmMomentAccumulator(total_samples=total_samples) if evaluator else None
    rng = torch.Generator(device=device).manual_seed(seed + p_idx)
    logger.info(f"generating {len(labels)} samples in {num_batches} batches of {batch_size} "
                f"on each of {p_cnt} process(es)")
    batch_seconds = []
    try:
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
                acts, logits = (feats[k][:valid].cpu().numpy()
                                for k in ("2048", "logits_unbiased"))
                local_idx = np.arange(i * batch_size, i * batch_size + valid)
                accum.update(acts, logits, local_idx * p_cnt + p_idx)
                times.update(inception=t2 - t1, moments=time.perf_counter() - t2)
            batch_seconds.append(times)
            if (i + 1) % 10 == 0:
                logger.info(f"generated {min((i + 1) * batch_size, len(labels))} samples")
    finally:
        if hasattr(sampler, "close"):  # the split's workers
            sampler.close()

    results = {}
    if accum is not None:
        accum.merge_across_hosts()
        if accum.count != total_samples:
            raise RuntimeError(f"accumulated {accum.count} != eval.total_samples {total_samples}")
        results["InceptionScore"] = accum.inception_score()
        if has_stats:
            ref_stats = evaluator.read_statistics(stats_path, None)
            results["FID"] = accum.fid_statistics().frechet_distance(ref_stats)
        else:
            logger.warning(f"eval.stats_path {stats_path!r} missing — FID skipped")

    logger.info(f"Results for {vq_cfg.get('token_size')} bits with "
                f"{mlm_cfg.get('num_steps')} steps: {results}")
    if is_main_process():
        print(json.dumps(results))
        with open(os.path.join(ctx["output_dir"], "eval_results.json"), "w") as f:
            json.dump(results, f, indent=2)
    return {"results": results, "count": accum.count if accum is not None else None,
            "accumulator": accum, "local_samples": len(labels),
            "batch_seconds": batch_seconds, "output_dir": ctx["output_dir"]}


if __name__ == "__main__":
    main()
