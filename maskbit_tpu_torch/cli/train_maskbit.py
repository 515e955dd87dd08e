"""Stage-II generator training entry point (PyTorch, one device).

    python -m maskbit_tpu_torch.cli.train_maskbit \\
        config=configs/generator/maskbit_generator_14bit.yaml training.device=cuda

Counterpart of `maskbit_tpu/cli/train_maskbit.py`. LFQBert trains with the
MLM loss, clip + AdamW on the configured LR schedule, and an EMA of its
weights, from one of three inputs:
  * `dataset.params.token_shards_path_or_url` set: pre-tokenized shards
    (`cli/pretokenize.py`, `TokenShardDataset`), no tokenizer in the step;
  * else tar shards at `dataset.params.train_shards_path_or_url`, when the
    first exists (`SimpleImagenet`), or synthetic batches: the frozen Stage-I
    tokenizer (from `experiment.vqgan_checkpoint`, a `.bin`; without one,
    seeded random weights) encodes each image batch inside the step.
`training.max_train_steps` steps are taken (`training.overfit_batch`
honoured); scalars and samples/s are logged every `experiment.log_every`
steps through the `experiment.logger` tracker (jsonl by default:
`metrics.jsonl`), per-parameter gradient norms every
`experiment.log_grad_norm_every` steps (0: never).

Checkpoints: every `experiment.save_every` steps, and at the end, the train
state (parameters, AdamW moments and counts, EMA, step) goes to
`checkpoints/` (`core.checkpoint.CheckpointManager`, the newest 3 kept), and
`model-{step}.bin` and `ema_model-{step}.bin` (the original repo's state-dict
layout) beside it. With `experiment.resume` (default true) a run restores the
newest checkpoint and goes on from its step; `experiment.resume_lr_scheduler:
false` restarts the schedule and Adam's bias correction (moments kept),
`experiment.dont_resume_optimizer: true` starts the optimizer afresh. SIGTERM
stops the run after the step in flight, with a final checkpoint.

Every `experiment.generate_every` steps the sampler runs with the EMA weights
on the batch's first `training.num_generated_images` labels and logs the
grid ("train/generated"), and the step's true and predicted tokens are
decoded side by side ("train/decoded"). Every `experiment.eval_every` steps
`eval.num_generation_samples` (default 2000) EMA samples of random labels,
in batches of `eval.generation_batch_size` (default 50), are scored by
`GeneratorEvaluator`: the Inception Score, and FID against
`eval.stats_path` when it exists, logged as "eval/InceptionScore" and
"eval/FID". Without Inception weights (`MASKBIT_INCEPTION_WEIGHTS`,
`MASKBIT_ADM_PB`) the eval is skipped with a log line.

Randomness, as in the JAX CLI: the step stream is a generator seeded with
`training.seed + 1`, also after a restore (a resumed run does not continue
the stream where the saved run left it); each generation takes its sampler's
seed from that stream. Each eval draws from a generator of its own, seeded
from `training.seed` and the step, and leaves the step stream as it was.
`training.device` (default "cuda") names the device;
CUDA requested and absent is an error.
"""

from __future__ import annotations

import itertools
import logging
import os
import sys
import time

import numpy as np
import torch

from maskbit_tpu_torch.cli.common import (
    GracefulShutdown,
    StepTimer,
    build_dataloaders,
    build_module,
    build_tokenizer,
    compute_dtype,
    reset_optimizer_counts,
    resolve_device,
    stdout_logger,
    validate_generator_config,
)
from maskbit_tpu_torch.core.checkpoint import CheckpointManager, save_pretrained
from maskbit_tpu_torch.core.config import config_from_cli
from maskbit_tpu_torch.core.ema import swapped_in
from maskbit_tpu_torch.data.token_shards import TokenShardDataset
from maskbit_tpu_torch.eval.fid import load_stats_npz
from maskbit_tpu_torch.eval.streaming import GeneratorEvaluator
from maskbit_tpu_torch.losses.mlm import MLMLossConfig
from maskbit_tpu_torch.models.generator import init_generator_weights_, make_generator
from maskbit_tpu_torch.ops.bitops import combine_factorized_tokens
from maskbit_tpu_torch.sampling.sample import SamplingConfig, make_sampler
from maskbit_tpu_torch.train.generator_trainer import (
    init_generator_train_state,
    make_generator_train_step,
    make_generator_train_step_from_tokens,
)
from maskbit_tpu_torch.train.optim import make_optimizer
from maskbit_tpu_torch.utils.lr_schedules import get_schedule
from maskbit_tpu_torch.utils.tracker import create_tracker
from maskbit_tpu_torch.utils.viz import (
    make_viz_generated_stage_two,
    make_viz_reconstructed_stage_two,
)


def _logger() -> logging.Logger:
    return stdout_logger("maskbit_tpu_torch.train")


def build_training(config, logger) -> dict:
    """Everything a run needs, from a config: {"device", "dtype",
    "output_dir", "tokenizer", "generator", "state", "train_step",
    "token_shards", "batch_size", "train_iter", "rng"}."""
    validate_generator_config(config)
    device = resolve_device(config, "training.device")
    dtype = compute_dtype(config, default="no")
    seed = int(config.select("training.seed", 42))
    name = config.select("experiment.name", "run")
    output_dir = config.select("experiment.output_dir", "") or os.path.join(
        os.environ.get("WORKSPACE", "./workspace"), name)
    os.makedirs(output_dir, exist_ok=True)
    config.save_yaml(os.path.join(output_dir, "config.yaml"))

    vq_cfg, mlm_cfg = config.model.vq_model, config.model.mlm_model
    tokenizer = build_tokenizer(config, logger, device, dtype)
    generator = build_module(lambda: make_generator(mlm_cfg.get("model_cls", "lfq_bert"),
                                                    mlm_cfg, vq_cfg, dtype=dtype), device)
    init_generator_weights_(generator, torch.Generator(device=device).manual_seed(seed))
    n_params = sum(p.numel() for p in generator.parameters())
    logger.info(f"generator: {n_params / 1e6:.2f}M parameters on {device}, compute {dtype}"
                f"{', remat' if mlm_cfg.get('remat', False) else ''}")

    max_steps = int(config.select("training.max_train_steps", 1_000_000))
    opt_cfg = config.optimizer.params
    opt = make_optimizer(
        generator.parameters(),
        get_schedule(config.select("lr_scheduler.scheduler", "constant"),
                     opt_cfg.get("learning_rate", 1e-4),
                     num_warmup_steps=config.select("lr_scheduler.params.warmup_steps", 5000),
                     num_training_steps=max_steps,
                     minimum_rate=config.select("lr_scheduler.params.minimum_rate", 0.1)),
        beta1=opt_cfg.get("beta1", 0.9), beta2=opt_cfg.get("beta2", 0.96),
        weight_decay=opt_cfg.get("weight_decay", 0.045), epsilon=opt_cfg.get("epsilon", 1e-8),
        max_grad_norm=config.select("training.max_grad_norm", 1.0),
        gradient_accumulation_steps=config.select("training.gradient_accumulation_steps", 1))
    state = init_generator_train_state(generator, opt,
                                       use_ema=config.select("training.use_ema", True))
    log_grad_norm_every = int(config.select("experiment.log_grad_norm_every", 0))
    step_kwargs = dict(mask_schedule=mlm_cfg.get("train_mask_schedule_strategy", "arccos"),
                       class_label_dropout=mlm_cfg.get("class_label_dropout", 0.1),
                       ema_kwargs={"decay": 0.9999},
                       log_param_grad_norms=0 < log_grad_norm_every <= max_steps)
    loss_cfg = MLMLossConfig.from_config(config.select("losses.mlm", {}))
    token_shards = config.select("dataset.params.token_shards_path_or_url", "")
    if token_shards:
        train_step = make_generator_train_step_from_tokens(
            generator, vq_cfg.get("codebook_size", 1024), loss_cfg, **step_kwargs)
    else:
        train_step = make_generator_train_step(generator, tokenizer, loss_cfg, **step_kwargs)
    batch_size = int(config.select("training.per_device_batch_size", 32))
    return {"device": device, "dtype": dtype, "output_dir": output_dir,
            "tokenizer": tokenizer, "generator": generator, "state": state,
            "train_step": train_step, "token_shards": token_shards, "batch_size": batch_size,
            "train_iter": build_train_iter(config, logger, token_shards, batch_size),
            "rng": torch.Generator(device=device).manual_seed(seed + 1)}


def build_train_iter(config, logger, token_shards: str, batch_size: int):
    """Batches of {"tokens" or "image", "class_id"} numpy arrays."""
    if token_shards:
        logger.info(f"training from pre-tokenized shards {token_shards}")
        dataset = TokenShardDataset(token_shards, resample=True,
                                    seed=int(config.select("training.seed", 42)))
        train_iter = dataset.batches(batch_size)
    else:
        train_iter = build_dataloaders(config, logger, batch_size)[0]()
    if config.select("training.overfit_batch", False):
        n = config.select("training.overfit_batch_num", 1)
        train_iter = itertools.cycle([next(train_iter) for _ in range(n)])
        logger.info(f"overfitting on {n} cached batch(es)")
    return train_iter


def next_batch(run: dict):
    """The next (tokens or images, labels) on the run's device."""
    batch = next(run["train_iter"])
    inputs = batch["tokens" if run["token_shards"] else "image"]
    return (torch.from_numpy(inputs).to(run["device"]),
            torch.from_numpy(batch["class_id"]).to(run["device"]))


def restore(config, logger, ckpt: CheckpointManager, state) -> int:
    """Resume-latest with the original repo's opt-outs; the step to go on
    from (0 without a checkpoint or with `experiment.resume: false`)."""
    if not config.select("experiment.resume", True):
        return 0
    restored = ckpt.restore_latest(state)
    if restored is None:
        return 0
    step = restored[1]
    if not config.select("experiment.resume_lr_scheduler", True):
        reset_optimizer_counts(state.opt)
        logger.info("LR schedule position reset on resume")
    if config.select("experiment.dont_resume_optimizer", False):
        state.opt.reset()
        logger.info("optimizer state reset on resume")
    logger.info(f"resumed from step {step}")
    return step


def generate(run: dict, sampler, labels, seed: int) -> np.ndarray:
    """Samples for `labels` with the EMA weights (the trained ones without an
    EMA), NHWC float32 in [0, 1]."""
    state, generator, device = run["state"], run["generator"], run["device"]
    labels = torch.as_tensor(labels, dtype=torch.int64, device=device)
    rng = torch.Generator(device=device).manual_seed(seed)
    generator.eval()
    if state.ema is None:
        images, _ = sampler(labels, rng)
    else:
        with swapped_in(state.ema, generator):
            images, _ = sampler(labels, rng)
    return images.clamp(0, 1).float().cpu().numpy()


def eval_generation(run: dict, config, sampler, seed: int, logger):
    """In-training generation eval: IS (and FID against `eval.stats_path`)
    over EMA samples of random labels; the evaluator, or None (with a log
    line) without Inception weights."""
    from maskbit_tpu_torch.cli.eval_tokenizer import make_inception_fn

    num_samples = int(config.select("eval.num_generation_samples", 2000))
    batch_size = int(config.select("eval.generation_batch_size", 50))
    device = run["device"]
    inception_fn = make_inception_fn(device)
    if inception_fn is None:
        logger.info("in-training generation eval skipped (no inception weights); "
                    "run cli.eval_maskbit for the full 50k ADM gFID")
        return None
    real_mu = real_sigma = None
    stats_path = config.select("eval.stats_path", "")
    if stats_path and os.path.exists(stats_path):
        real_mu, real_sigma = load_stats_npz(stats_path)
    evaluator = GeneratorEvaluator(inception_fn, real_mu, real_sigma)
    rng = torch.Generator(device=device).manual_seed(seed)
    for _ in range(num_samples // batch_size):
        labels = torch.randint(0, 1000, (batch_size,), generator=rng, device=device)
        batch_seed = int(torch.randint(0, 2**62, (1,), generator=rng, device=device))
        evaluator.update(torch.from_numpy(generate(run, sampler, labels, batch_seed)))
    return evaluator


def decoded_pair(run: dict, viz: dict, codebook_size: int, splits: int, n: int) -> np.ndarray:
    """The tokenizer's decode of the step's true tokens beside that of the
    generator's argmax predictions, as one uint8 grid."""
    decode = run["tokenizer"].eval().decode_tokens
    with torch.inference_mode():
        recon, predicted = (
            decode(combine_factorized_tokens(viz[key][:n], codebook_size, splits))
            .clamp(0, 1).float().cpu().numpy()
            for key in ("_input_tokens", "_predicted_tokens"))
    return make_viz_reconstructed_stage_two(recon, predicted)[1]


def save_checkpoint(ckpt: CheckpointManager, run: dict, step: int, logger) -> float:
    """The train state (written in the background) and the bare `.bin`
    weights; returns the seconds the call held the loop."""
    t0 = time.perf_counter()
    state, generator, output_dir = run["state"], run["generator"], run["output_dir"]
    ckpt.save(step, state)
    save_pretrained(generator, os.path.join(output_dir, f"model-{step}.bin"))
    if state.ema is not None:
        save_pretrained(generator, os.path.join(output_dir, f"ema_model-{step}.bin"),
                        params=state.ema.params)
    seconds = time.perf_counter() - t0
    logger.info(f"saved checkpoint @ step {step} (model-{step}.bin, ema_model-{step}.bin) "
                f"in {seconds:.2f} s")
    return seconds


def main(argv=None) -> dict:
    """Train; returns {"output_dir", "steps", "resumed_from", "history":
    [logged scalars], "save_seconds": [each save's time in the loop],
    "checkpoint_timings": the manager's}."""
    config = config_from_cli(argv if argv is not None else sys.argv[1:])
    logger = _logger()
    run = build_training(config, logger)
    state, train_step, batch_size = run["state"], run["train_step"], run["batch_size"]
    output_dir, device = run["output_dir"], run["device"]
    vq_cfg, mlm_cfg = config.model.vq_model, config.model.mlm_model
    codebook_size, splits = vq_cfg.get("codebook_size", 1024), mlm_cfg.get("codebook_splits", 1)
    max_steps = int(config.select("training.max_train_steps", 1_000_000))
    log_every = int(config.select("experiment.log_every", 50))
    save_every = int(config.select("experiment.save_every", 100_000))
    generate_every = int(config.select("experiment.generate_every", 10_000))
    log_grad_norm_every = int(config.select("experiment.log_grad_norm_every", 0))
    eval_every = int(config.select("experiment.eval_every", 100_000))
    num_gen = int(config.select("training.num_generated_images", 4))

    ckpt = CheckpointManager(os.path.join(output_dir, "checkpoints"), max_to_keep=3)
    resumed_from = restore(config, logger, ckpt, state)
    last_saved = resumed_from if resumed_from else -1
    res = config.select("dataset.preprocessing.resolution", 256)
    sampler = make_sampler(run["generator"], run["tokenizer"], SamplingConfig.from_config(
        mlm_cfg, vq_cfg)._replace(patch_size=res // 2 ** (vq_cfg.get("num_resolutions", 5) - 1)))
    tracker = create_tracker(config.select("experiment.logger", "jsonl"), output_dir,
                             project=config.select("experiment.project", "maskbit_tpu"),
                             run_name=config.select("experiment.name", "run"),
                             config=config.to_dict())
    rng = run["rng"]
    timer = StepTimer()
    history, save_seconds = [], []
    shutdown = GracefulShutdown(logger)
    try:
        while state.step < max_steps:
            inputs, labels = next_batch(run)
            timer.data_tick()
            state, metrics = train_step(state, inputs, labels, rng)
            step = state.step
            if shutdown.should_stop():
                logger.warning(f"preemption: stopping cleanly at step {step}")
                break
            viz = {k: metrics.pop(k) for k in list(metrics) if k.startswith("_")}
            if log_grad_norm_every and step % log_grad_norm_every == 0:
                tracker.log({k: float(v) for k, v in metrics.items()
                             if k.startswith("grad_norm/")}, step)
            if step % log_every == 0:
                scalars = {k: float(v) for k, v in metrics.items()
                           if not k.startswith("grad_norm/")}
                timer.batch_tick()  # after the sync above: the step's device time
                # one device: the JAX CLI's per-device rate is the rate
                scalars["perf/samples_per_sec_per_device"] = batch_size / max(
                    timer.batch_time.avg, 1e-9)
                scalars["perf/step_seconds"] = timer.batch_time.val  # data included
                scalars["perf/data_seconds"] = timer.data_time.val
                history.append(dict(scalars, step=step))
                tracker.log(scalars, step)
                logger.info(f"step {step}: mlm={scalars['mlm_loss']:.4f} "
                            f"masked_acc={scalars['masked_correct_tokens']:.4f} "
                            f"{scalars['perf/samples_per_sec_per_device']:.1f} samples/s/dev")
            else:
                timer.batch_tick()
            if step % generate_every == 0:
                t0 = time.perf_counter()
                seed = int(torch.randint(0, 2**62, (1,), generator=rng, device=device))
                images = generate(run, sampler, labels[:num_gen], seed)
                tracker.log_image("train/generated", make_viz_generated_stage_two(images)[1], step)
                tracker.log_image("train/decoded",
                                  decoded_pair(run, viz, codebook_size, splits, num_gen), step)
                logger.info(f"generated {len(images)} images with the EMA weights at step {step} "
                            f"in {time.perf_counter() - t0:.2f} s")
                timer.restart()
            if step % save_every == 0:
                save_seconds.append(save_checkpoint(ckpt, run, step, logger))
                last_saved = step
                timer.restart()
            if step % eval_every == 0:
                seed = int(config.select("training.seed", 42)) + 0x5EED + step
                evaluator = eval_generation(run, config, sampler, seed, logger)
                results = evaluator.result() if evaluator is not None else {}
                if results:
                    tracker.log({f"eval/{k}": v for k, v in results.items()}, step)
                    logger.info(f"eval @ {step}: {results}")
                timer.restart()
        if state.step != last_saved:
            save_seconds.append(save_checkpoint(ckpt, run, state.step, logger))
        ckpt.close()
    finally:
        shutdown.close()
        tracker.close()
    return {"output_dir": output_dir, "steps": state.step, "resumed_from": resumed_from,
            "history": history, "save_seconds": save_seconds, "checkpoint_timings": ckpt.timings}


if __name__ == "__main__":
    main()
