"""Stage-I tokenizer training entry point (PyTorch, one device).

    python -m maskbit_tpu_torch.cli.train_tokenizer \\
        config=configs/tokenizer/maskbit_tokenizer_14bit.yaml training.device=cuda

Counterpart of `maskbit_tpu/cli/train_tokenizer.py`. The VQGAN+ tokenizer
(`model.vq_model`) trains against the PatchGAN discriminator
(`model.discriminator`) with the VQGAN loss (`losses`,
`train/tokenizer_trainer.py`): twin clip + AdamW optimizers on the
configured LR schedule (the discriminator's spans
`max_train_steps - discriminator_start` steps, as it steps only from the
gate on; `optimizer.params.scale_lr` multiplies both rates by batch x
accumulation steps; `training.gradient_accumulation_steps`), the
perceptual loss of `cli.common.build_perceptual` (off, with a warning,
without its weights), and an EMA of the tokenizer (decay 0.999). Weights
start from the JAX package's initialisation (seeded by `training.seed`)
or from `experiment.init_checkpoint` (a `.bin` or a JAX `.msgpack`). Data:
tar shards at `dataset.params.train_shards_path_or_url` when the first
exists, else synthetic batches; `training.overfit_batch` cycles cached
batches.

Every `experiment.log_every` steps the step's losses and metrics (the JAX
package's keys) and `perf/samples_per_sec_per_device` go to the
`experiment.logger` tracker (jsonl by default), per-parameter gradient
norms every `experiment.log_grad_norm_every` steps; every
`experiment.generate_every` steps the EMA weights reconstruct the batch's
first `training.num_generated_images` images ("train/reconstructions");
every `experiment.eval_every` steps `TokenizerEvaluator` scores the EMA
weights' reconstructions of the eval batches (at most
`eval.max_eval_batches`, default 50; 0 for all): PSNR, SSIM, MSE, MAE,
codebook usage and entropy, logged as "eval/...".

Checkpoints, as in `cli/train_maskbit.py`: every `experiment.save_every`
steps and at the end, the train state (both models, both optimizers, EMA,
LeCam state, step) goes to `checkpoints/` and `model-{step}.bin` and
`ema_model-{step}.bin` (the tokenizer, in the original repo's layout) beside
it: the port's stated divergence from the JAX CLI's `.msgpack`. With
`experiment.resume` (default true) a run restores the newest checkpoint;
`experiment.resume_lr_scheduler: false` restarts both schedules and Adam's
bias corrections, `experiment.dont_resume_optimizer: true` starts both
optimizers afresh. SIGTERM stops the run after the step in flight, with a
final checkpoint. `training.device` (default "cuda") names the device; CUDA
requested and absent is an error.
"""

from __future__ import annotations

import contextlib
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
    build_perceptual,
    compute_dtype,
    reset_optimizer_counts,
    resolve_device,
    stdout_logger,
)
from maskbit_tpu_torch.core.checkpoint import CheckpointManager, load_pretrained, save_pretrained
from maskbit_tpu_torch.core.config import config_from_cli
from maskbit_tpu_torch.core.ema import swapped_in
from maskbit_tpu_torch.eval.streaming import TokenizerEvaluator
from maskbit_tpu_torch.losses.vqgan import VQGANLossConfig
from maskbit_tpu_torch.models.tokenizer import ConvVQModel, init_tokenizer_weights_
from maskbit_tpu_torch.nn.discriminator import create_discriminator, init_discriminator_weights_
from maskbit_tpu_torch.train.optim import make_optimizer
from maskbit_tpu_torch.train.tokenizer_trainer import (
    init_tokenizer_train_state,
    make_tokenizer_train_step,
    trainable_parameters,
)
from maskbit_tpu_torch.utils.lr_schedules import get_schedule
from maskbit_tpu_torch.utils.tracker import create_tracker
from maskbit_tpu_torch.utils.viz import make_viz_from_samples


def _logger() -> logging.Logger:
    return stdout_logger("maskbit_tpu_torch.train_tokenizer")


def build_optimizers(config, model, discriminator, num_devices: int = 1):
    """(generator AdamW, discriminator AdamW) as the JAX CLI's
    `build_optimizers` configures its optax chains."""
    opt = config.optimizer.params
    lr = opt.get("learning_rate", 1e-4)
    disc_lr = opt.get("discriminator_learning_rate", lr)
    accum = config.select("training.gradient_accumulation_steps", 1)
    if opt.get("scale_lr", False):
        scale = config.select("training.per_device_batch_size", 16) * num_devices * accum
        lr, disc_lr = lr * scale, disc_lr * scale
    max_steps = config.select("training.max_train_steps", 1_000_000)
    sched_name = config.select("lr_scheduler.scheduler", "constant")
    sched_kwargs = dict(num_warmup_steps=config.select("lr_scheduler.params.warmup_steps", 5000),
                        minimum_rate=config.select("lr_scheduler.params.minimum_rate", 0.1))
    common = dict(beta1=opt.get("beta1", 0.9), beta2=opt.get("beta2", 0.999),
                  weight_decay=opt.get("weight_decay", 1e-4), epsilon=opt.get("epsilon", 1e-8),
                  max_grad_norm=config.select("training.max_grad_norm", 1.0),
                  gradient_accumulation_steps=accum)
    finetune = config.select("model.vq_model.finetune_decoder", False)
    gen_opt = make_optimizer(
        trainable_parameters(model, finetune),
        get_schedule(sched_name, lr, num_training_steps=max_steps, **sched_kwargs), **common)
    disc_steps = max(1, max_steps - config.select("losses.discriminator_start", 0))
    disc_opt = make_optimizer(
        discriminator.parameters(),
        get_schedule(sched_name, disc_lr, num_training_steps=disc_steps, **sched_kwargs),
        **common)
    return gen_opt, disc_opt


def build_training(config, logger) -> dict:
    """Everything a run needs, from a config: {"device", "dtype",
    "output_dir", "model", "discriminator", "perceptual", "loss_cfg",
    "state", "train_step", "batch_size"}."""
    device = resolve_device(config, "training.device")
    dtype = compute_dtype(config, "no")
    seed = int(config.select("training.seed", 42))
    output_dir = config.select("experiment.output_dir", "") or os.path.join(
        os.environ.get("WORKSPACE", "./workspace"), config.select("experiment.name", "run"))
    os.makedirs(output_dir, exist_ok=True)
    config.save_yaml(os.path.join(output_dir, "config.yaml"))

    model = build_module(lambda: ConvVQModel.from_config(config.model.vq_model, dtype=dtype),
                         device)
    init_tokenizer_weights_(model, torch.Generator(device=device).manual_seed(seed))
    discriminator = build_module(lambda: create_discriminator(config.model.discriminator, dtype),
                                 device)
    init_discriminator_weights_(discriminator,
                                torch.Generator(device=device).manual_seed(seed + 1))
    init_ckpt = config.select("experiment.init_checkpoint", "")
    if init_ckpt and os.path.exists(init_ckpt):
        model.load_state_dict(load_pretrained(init_ckpt, device), strict=True)
        logger.info(f"initialized weights from {init_ckpt}")
    for name, module in (("tokenizer", model), ("discriminator", discriminator)):
        n = sum(p.numel() for p in module.parameters())
        logger.info(f"{name}: {n / 1e6:.2f}M parameters on {device}, compute {dtype}")

    loss_cfg = VQGANLossConfig.from_config(config.losses)
    perceptual = build_perceptual(config, logger, device)
    if perceptual is None and loss_cfg.perceptual_weight > 0:
        loss_cfg = loss_cfg._replace(perceptual_loss="none", perceptual_weight=0.0)

    gen_opt, disc_opt = build_optimizers(config, model, discriminator)
    state = init_tokenizer_train_state(model, discriminator, gen_opt, disc_opt,
                                       use_ema=config.select("training.use_ema", True))
    max_steps = int(config.select("training.max_train_steps", 1_000_000))
    log_grad_norm_every = int(config.select("experiment.log_grad_norm_every", 0))
    train_step = make_tokenizer_train_step(
        model, discriminator, loss_cfg, perceptual_fn=perceptual, ema_kwargs={"decay": 0.999},
        log_param_grad_norms=0 < log_grad_norm_every <= max_steps)
    return {"device": device, "dtype": dtype, "output_dir": output_dir, "model": model,
            "discriminator": discriminator, "perceptual": perceptual, "loss_cfg": loss_cfg,
            "state": state, "train_step": train_step,
            "batch_size": int(config.select("training.per_device_batch_size", 16))}


def restore(config, logger, ckpt: CheckpointManager, state) -> int:
    """Resume-latest with the original repo's opt-outs, for both optimizers;
    the step to go on from (0 without a checkpoint or with
    `experiment.resume: false`)."""
    if not config.select("experiment.resume", True):
        return 0
    restored = ckpt.restore_latest(state)
    if restored is None:
        return 0
    if not config.select("experiment.resume_lr_scheduler", True):
        reset_optimizer_counts(state.gen_opt)
        reset_optimizer_counts(state.disc_opt)
        logger.info("LR schedule position reset on resume")
    if config.select("experiment.dont_resume_optimizer", False):
        state.gen_opt.reset()
        state.disc_opt.reset()
        logger.info("optimizer state reset on resume")
    logger.info(f"resumed from step {restored[1]}")
    return restored[1]


def _eval_weights(run: dict):
    """The EMA weights lent to the model (the trained ones without an EMA)."""
    state = run["state"]
    if state.ema is None:
        return contextlib.nullcontext(run["model"])
    return swapped_in(state.ema, run["model"])


def reconstruct(run: dict, images: torch.Tensor) -> np.ndarray:
    """Reconstructions of `images` with the EMA weights, NHWC float32 in [0, 1]."""
    with _eval_weights(run) as model, torch.inference_mode():
        recons, _ = model.eval()(images)
    return recons.clamp(0.0, 1.0).float().cpu().numpy()


def eval_reconstruction(run: dict, eval_batches, config) -> dict:
    """In-training eval of the EMA weights: PSNR, SSIM, MSE, MAE, codebook
    usage and entropy over at most `eval.max_eval_batches` batches."""
    max_batches = int(config.select("eval.max_eval_batches", 50))
    evaluator = TokenizerEvaluator(
        enable_psnr_score=True, enable_ssim_score=True, enable_mse_error=True,
        enable_mae_error=True, enable_codebook_usage_measure=True,
        enable_codebook_entropy_measure=True,
        num_codebook_entries=config.select("model.vq_model.codebook_size", 1024))
    with _eval_weights(run) as model, torch.inference_mode():
        for i, batch in enumerate(eval_batches):
            if max_batches and i >= max_batches:
                break
            images = torch.from_numpy(batch["image"]).to(run["device"])
            recons, result = model.eval()(images)
            evaluator.update(images, recons.clamp(0.0, 1.0),
                             codebook_indices=result["min_encoding_indices"])
    return evaluator.result()


def save_checkpoint(ckpt: CheckpointManager, run: dict, step: int, logger) -> float:
    """The train state (written in the background) and the tokenizer's bare
    `.bin` weights; returns the seconds the call held the loop."""
    t0 = time.perf_counter()
    state, model, output_dir = run["state"], run["model"], run["output_dir"]
    ckpt.save(step, state)
    save_pretrained(model, os.path.join(output_dir, f"model-{step}.bin"))
    if state.ema is not None:
        save_pretrained(model, os.path.join(output_dir, f"ema_model-{step}.bin"),
                        params=state.ema.params)
    seconds = time.perf_counter() - t0
    logger.info(f"saved checkpoint @ step {step} in {seconds:.2f} s")
    return seconds


def main(argv=None) -> dict:
    """Train; returns {"output_dir", "steps", "resumed_from", "history":
    [logged scalars], "evals": [{"step", **results}], "save_seconds",
    "checkpoint_timings", "perceptual": whether the perceptual loss is on}."""
    config = config_from_cli(argv if argv is not None else sys.argv[1:])
    logger = _logger()
    run = build_training(config, logger)
    state, train_step, batch_size = run["state"], run["train_step"], run["batch_size"]
    output_dir, device = run["output_dir"], run["device"]
    max_steps = int(config.select("training.max_train_steps", 1_000_000))
    log_every = int(config.select("experiment.log_every", 50))
    save_every = int(config.select("experiment.save_every", 20_000))
    eval_every = int(config.select("experiment.eval_every", 20_000))
    generate_every = int(config.select("experiment.generate_every", 2000))
    log_grad_norm_every = int(config.select("experiment.log_grad_norm_every", 0))
    num_images = int(config.select("training.num_generated_images", 2))

    ckpt = CheckpointManager(os.path.join(output_dir, "checkpoints"), max_to_keep=3)
    resumed_from = restore(config, logger, ckpt, state)
    last_saved = resumed_from if resumed_from else -1
    make_train, make_eval, _ = build_dataloaders(config, logger, batch_size)
    train_iter = make_train()
    if config.select("training.overfit_batch", False):
        n = config.select("training.overfit_batch_num", 1)
        train_iter = itertools.cycle([next(train_iter) for _ in range(n)])
        logger.info(f"overfitting on {n} cached batch(es)")
    tracker = create_tracker(config.select("experiment.logger", "jsonl"), output_dir,
                             project=config.select("experiment.project", "maskbit_tpu"),
                             run_name=config.select("experiment.name", "run"),
                             config=config.to_dict())
    timer = StepTimer()
    history, evals, save_seconds = [], [], []
    shutdown = GracefulShutdown(logger)
    try:
        while state.step < max_steps:
            batch = next(train_iter)
            images = torch.from_numpy(batch["image"]).to(device)
            timer.data_tick()
            state, metrics = train_step(state, images)
            step = state.step
            if shutdown.should_stop():
                logger.warning(f"preemption: stopping cleanly at step {step}")
                break
            if log_grad_norm_every and step % log_grad_norm_every == 0:
                tracker.log({k: float(v) for k, v in metrics.items()
                             if k.startswith("grad_norm/")}, step)
            if step % log_every == 0:
                scalars = {k: float(v) for k, v in metrics.items()
                           if not k.startswith("grad_norm/")}
                timer.batch_tick()  # after the sync above: the step's device time
                scalars["perf/samples_per_sec_per_device"] = batch_size / max(
                    timer.batch_time.avg, 1e-9)
                scalars["perf/batch_time"] = timer.batch_time.avg
                scalars["perf/data_time"] = timer.data_time.avg
                scalars["perf/step_seconds"] = timer.batch_time.val
                history.append(dict(scalars, step=step))
                tracker.log(scalars, step)
                logger.info(f"step {step}: total={scalars['total_loss']:.4f} "
                            f"recon={scalars['reconstruction_loss']:.4f} "
                            f"{scalars['perf/samples_per_sec_per_device']:.1f} samples/s/dev")
            else:
                timer.batch_tick()
            if step % generate_every == 0:
                shown = images[:num_images]
                grid = make_viz_from_samples(shown.cpu().numpy(), reconstruct(run, shown))[1]
                tracker.log_image("train/reconstructions", grid, step)
                timer.restart()
            if step % save_every == 0:
                save_seconds.append(save_checkpoint(ckpt, run, step, logger))
                last_saved = step
                timer.restart()
            if step % eval_every == 0:
                results = eval_reconstruction(run, make_eval(), config)
                tracker.log({f"eval/{k}": v for k, v in results.items()}, step)
                logger.info(f"eval @ {step}: {results}")
                evals.append(dict(results, step=step))
                timer.restart()
        if state.step != last_saved:
            save_seconds.append(save_checkpoint(ckpt, run, state.step, logger))
        ckpt.close()
    finally:
        shutdown.close()
        tracker.close()
    return {"output_dir": output_dir, "steps": state.step, "resumed_from": resumed_from,
            "history": history, "evals": evals, "save_seconds": save_seconds,
            "checkpoint_timings": ckpt.timings, "perceptual": run["perceptual"] is not None}


if __name__ == "__main__":
    main()
