"""Stage-II generator training entry point (PyTorch, one device).

    python -m maskbit_tpu_torch.cli.train_maskbit \\
        config=configs/generator/maskbit_generator_14bit.yaml training.device=cuda

Counterpart of the default path of `maskbit_tpu/cli/train_maskbit.py`: a
frozen Stage-I tokenizer (from `experiment.vqgan_checkpoint`, a `.bin`;
without one, seeded random weights) encodes each image batch inline;
LFQBert trains with the MLM loss, clip + AdamW on the configured LR
schedule, and an EMA of its weights. `training.max_train_steps` steps are
taken (`training.overfit_batch` honoured); `mlm_loss`,
`masked_correct_tokens` and samples/s are logged every
`experiment.log_every` steps (also to `metrics.jsonl`); the run ends by
writing `model-{step}.bin` and `ema_model-{step}.bin` (the original repo's
state-dict layout) under `experiment.output_dir` (default
`$WORKSPACE/<experiment.name>`, WORKSPACE defaulting to ./workspace).

`training.device` (default "cuda") names the device; CUDA requested and
absent is an error. Without train shards the batches are synthetic, as in
the JAX CLI; with shards it raises (the tar reader is not ported yet).
Resume, pre-tokenized shards, in-training generation, eval and
visualisation are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import sys

import torch

from maskbit_tpu_torch.cli.common import (
    StepTimer,
    build_dataloaders,
    build_module,
    compute_dtype,
    random_init_,
    validate_generator_config,
)
from maskbit_tpu_torch.core.checkpoint import load_pretrained, save_pretrained
from maskbit_tpu_torch.core.config import config_from_cli
from maskbit_tpu_torch.losses.mlm import MLMLossConfig
from maskbit_tpu_torch.models.generator import init_generator_weights_, make_generator
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from maskbit_tpu_torch.train.generator_trainer import (
    init_generator_train_state,
    make_generator_train_step,
)
from maskbit_tpu_torch.train.optim import make_optimizer
from maskbit_tpu_torch.utils.lr_schedules import get_schedule


def _logger() -> logging.Logger:
    logger = logging.getLogger("maskbit_tpu_torch.train")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger


def _device(config) -> torch.device:
    device = torch.device(config.select("training.device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training.device is cuda but no CUDA device is available")
    return device


def build_tokenizer(config, logger, device, dtype) -> ConvVQModel:
    """The frozen Stage-I tokenizer, weights stored in the compute dtype."""
    tokenizer = build_module(lambda: ConvVQModel.from_config(config.model.vq_model, dtype=dtype),
                             device)
    path = config.select("experiment.vqgan_checkpoint", "")
    if path and os.path.exists(path):
        tokenizer.load_state_dict(load_pretrained(path, device), strict=True)
        logger.info(f"loaded frozen tokenizer from {path}")
    else:
        logger.warning(f"vqgan_checkpoint {path!r} not found — initializing a RANDOM frozen "
                       "tokenizer (smoke-test mode only).")
        random_init_(tokenizer, torch.Generator(device=device).manual_seed(0))
    return tokenizer.to(dtype).requires_grad_(False)


def build_training(config, logger) -> dict:
    """Everything a run needs, from a config: {"device", "dtype",
    "output_dir", "tokenizer", "generator", "state", "train_step",
    "batch_size", "train_iter", "rng"}."""
    validate_generator_config(config)
    device = _device(config)
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
    logger.info(f"generator: {n_params / 1e6:.2f}M parameters on {device}, compute {dtype}")

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
    train_step = make_generator_train_step(
        generator, tokenizer, MLMLossConfig.from_config(config.select("losses.mlm", {})),
        mask_schedule=mlm_cfg.get("train_mask_schedule_strategy", "arccos"),
        class_label_dropout=mlm_cfg.get("class_label_dropout", 0.1),
        ema_kwargs={"decay": 0.9999})

    batch_size = int(config.select("training.per_device_batch_size", 32))
    train_iter = build_dataloaders(config, logger, batch_size)()
    if config.select("training.overfit_batch", False):
        n = config.select("training.overfit_batch_num", 1)
        train_iter = itertools.cycle([next(train_iter) for _ in range(n)])
        logger.info(f"overfitting on {n} cached batch(es)")
    return {"device": device, "dtype": dtype, "output_dir": output_dir,
            "tokenizer": tokenizer, "generator": generator, "state": state,
            "train_step": train_step, "batch_size": batch_size, "train_iter": train_iter,
            "rng": torch.Generator(device=device).manual_seed(seed + 1)}


def next_batch(run: dict):
    """The next (images, labels) on the run's device."""
    batch = next(run["train_iter"])
    return (torch.from_numpy(batch["image"]).to(run["device"]),
            torch.from_numpy(batch["class_id"]).to(run["device"]))


def main(argv=None) -> dict:
    """Train; returns {"output_dir", "steps", "history": [logged metrics]}."""
    config = config_from_cli(argv if argv is not None else sys.argv[1:])
    logger = _logger()
    run = build_training(config, logger)
    state, train_step, batch_size = run["state"], run["train_step"], run["batch_size"]
    output_dir, generator = run["output_dir"], run["generator"]
    max_steps = int(config.select("training.max_train_steps", 1_000_000))
    log_every = int(config.select("experiment.log_every", 50))
    timer = StepTimer()
    history = []
    with open(os.path.join(output_dir, "metrics.jsonl"), "a") as metrics_file:
        while state.step < max_steps:
            images, labels = next_batch(run)
            timer.data_tick()
            state, metrics = train_step(state, images, labels, run["rng"])
            if state.step % log_every == 0:
                scalars = {k: float(v) for k, v in metrics.items() if not k.startswith("_")}
                timer.batch_tick()  # after the sync above: the step's device time
                scalars["perf/samples_per_sec"] = batch_size / max(timer.batch_time.avg, 1e-9)
                scalars["perf/step_seconds"] = timer.batch_time.val  # data included
                scalars["perf/data_seconds"] = timer.data_time.val
                history.append(dict(scalars, step=state.step))
                metrics_file.write(json.dumps(history[-1]) + "\n")
                logger.info(f"step {state.step}: mlm={scalars['mlm_loss']:.4f} "
                            f"masked_acc={scalars['masked_correct_tokens']:.4f} "
                            f"{scalars['perf/samples_per_sec']:.1f} samples/s")
            else:
                timer.batch_tick()

    step = state.step
    save_pretrained(generator, os.path.join(output_dir, f"model-{step}.bin"))
    if state.ema is not None:
        save_pretrained(generator, os.path.join(output_dir, f"ema_model-{step}.bin"),
                        params=state.ema.params)
    logger.info(f"saved model-{step}.bin and ema_model-{step}.bin under {output_dir}")
    return {"output_dir": output_dir, "steps": step, "history": history}


if __name__ == "__main__":
    main()
