"""Shared plumbing for the port's entry points.

Counterpart of `maskbit_tpu/cli/common.py`'s `validate_generator_config`,
`resolve_compute_dtype` (here `compute_dtype`), `load_generation_models`,
`setup_experiment`, `synthetic_batches`, `build_dataloaders`,
`build_perceptual`, `reset_optimizer_counts`, `ProfilerHook`,
`GracefulShutdown` and `StepTimer`; `setup_device` joins the process group and lays out the
(data, fsdp, tensor) mesh of the config's `parallel` node
(`parallel/mesh.py`) where the JAX package's `setup_experiment` calls
`maybe_init_distributed` and builds its mesh. Under several processes each
batch shard (the ranks of one tensor group share one) feeds its share of
the global batch, evaluation splits its data over every process, and the
main process alone writes directories, configs and logs. `expand_shard_pattern` lives in `data/tar_reader.py` and is
re-exported here.
"""

from __future__ import annotations

import logging
import math
import os
import signal
import time
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from maskbit_tpu_torch.core.checkpoint import load_pretrained
from maskbit_tpu_torch.data.tar_reader import SimpleImagenet, expand_shard_pattern
from maskbit_tpu_torch.models.generator import make_generator
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from maskbit_tpu_torch.parallel.mesh import (
    MeshConfig,
    batch_shard_count,
    batch_shard_index,
    init_mesh,
    is_main_process,
    maybe_init_distributed,
    process_allgather_f64,
    process_count,
    process_index,
)
from maskbit_tpu_torch.sampling.sample import SamplingConfig
from maskbit_tpu_torch.utils.meter import AverageMeter


def resolve_device(config, key: str) -> torch.device:
    """The device the config names at `key` (default "cuda"); CUDA named and
    absent is an error."""
    device = torch.device(config.select(key, "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{key} is cuda but no CUDA device is available")
    return device


def setup_device(config, key: str, logger: Optional[logging.Logger] = None) -> torch.device:
    """`resolve_device`, then join the process group when torchrun started
    several processes (`parallel.mesh.maybe_init_distributed`) and lay out
    the mesh of the `parallel` node: `data x fsdp x tensor` must equal the
    process count (`data: -1` takes the rest), and the batch, fsdp, tensor,
    data and model groups are made (`parallel.mesh.init_mesh`, a
    collective). Returns the device this process computes on."""
    device = maybe_init_distributed(resolve_device(config, key), logger)
    mesh = init_mesh(MeshConfig.from_config(config))
    if process_count() > 1 and logger is not None:
        logger.info(f"mesh data={mesh.shape.data} fsdp={mesh.shape.fsdp} "
                    f"tensor={mesh.shape.tensor}; this rank (d, f, t) = {mesh.coords}")
    return device


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


def build_tokenizer(config, logger, device, dtype) -> ConvVQModel:
    """The frozen Stage-I tokenizer from `experiment.vqgan_checkpoint` (a
    `.bin`; without one, seeded random weights and a warning), weights
    stored in the compute dtype."""
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


def synthetic_batches(batch_size: int, resolution: int, seed: int = 0) -> Iterator[dict]:
    """Random image/label batches (numpy, NHWC in [0, 1]); the same stream
    as the JAX package's for the same seed (`build_dataloaders` adds the
    process index to the seed, so each process draws its own)."""
    rng = np.random.default_rng(seed)
    while True:
        yield {
            "image": rng.uniform(size=(batch_size, resolution, resolution, 3)).astype(np.float32),
            "class_id": rng.integers(0, 1000, size=(batch_size,)).astype(np.int32),
        }


def output_directory(config, subdir: str = "") -> str:
    """`experiment.output_dir` when set, else `$WORKSPACE/<experiment.name>`
    (WORKSPACE defaults to ./workspace), then `subdir`; made, with the
    config saved there as config.yaml, by the main process."""
    base = config.select("experiment.output_dir", "") or os.path.join(
        os.environ.get("WORKSPACE", "./workspace"), config.select("experiment.name", "run"))
    output_dir = os.path.join(base, subdir) if subdir else base
    if is_main_process():
        os.makedirs(output_dir, exist_ok=True)
        config.save_yaml(os.path.join(output_dir, "config.yaml"))
    return output_dir


def setup_experiment(config, subdir: str = "") -> dict:
    """The evaluation entry points' device, output directory and logger:
    {"device", "output_dir", "logger", "seed"} (`setup_device` on
    `eval.device`, `output_directory`)."""
    from maskbit_tpu_torch.utils.logger import setup_logger

    logger = setup_logger("maskbit_tpu_torch.eval")
    device = setup_device(config, "eval.device", logger)
    return {"device": device, "output_dir": output_directory(config, subdir), "logger": logger,
            "seed": int(config.select("training.seed", 42))}


def build_dataloaders(config, logger, global_batch_size: int
                      ) -> Tuple[Callable[[], Iterator[dict]], Callable[[], Iterator[dict]], bool]:
    """(train iterator factory, eval iterator factory, synthetic?): the
    train batches of this rank's batch shard (`batch_shard_index` of
    `batch_shard_count`, `global_batch_size // batch_shard_count()` rows;
    the ranks of one tensor group read the same), and the eval batches of
    this process (`process_index` of `process_count`: evaluation runs
    data-parallel over every process, with whole weights), each
    `global_batch_size // process_count()` rows. `SimpleImagenet` over the
    train and eval shards when the first train shard exists; otherwise
    endless synthetic train batches (seed: the batch shard's index) and, for
    eval, two copies of the first synthetic batch of seed 1 + the process
    index, as in the JAX package."""
    params = config.dataset.params
    prep = config.dataset.preprocessing
    resolution = prep.get("resolution", 256)
    train_shards = params.get("train_shards_path_or_url", "")
    expanded = expand_shard_pattern(train_shards) if train_shards else []
    if not (expanded and os.path.exists(expanded[0])):
        logger.warning(f"Train shards {train_shards!r} not found — using SYNTHETIC data. "
                       "Point dataset.params.train_shards_path_or_url at real shards for training.")
        per_shard, shard = global_batch_size // batch_shard_count(), batch_shard_index()
        per_process, rank = global_batch_size // process_count(), process_index()
        make_eval = lambda: iter(  # noqa: E731
            [next(synthetic_batches(per_process, resolution, seed=1 + rank)) for _ in range(2)])
        return lambda: synthetic_batches(per_shard, resolution, seed=shard), make_eval, True
    logger.info(f"training from tar shards {train_shards!r} ({len(expanded)} shards)")

    def data(index: int, count: int) -> SimpleImagenet:
        return SimpleImagenet(
            train_shards_path_or_url=train_shards,
            eval_shards_path_or_url=params.get("eval_shards_path_or_url", train_shards),
            num_train_examples=config.select("experiment.max_train_examples", 1_281_167),
            per_device_batch_size=config.select("training.per_device_batch_size", 16),
            global_batch_size=global_batch_size,
            num_workers_per_device=params.get("num_workers_per_device", 8),
            resolution=resolution,
            shuffle_buffer_size=params.get("shuffle_buffer_size", 1000),
            min_scale=prep.get("min_scale", 0.8),
            use_aspect_ratio_aug=prep.get("use_aspect_ratio_aug", True),
            use_random_crop=prep.get("use_random_crop", True),
            interpolation=prep.get("interpolation", "bilinear"),
            seed=int(config.select("training.seed", 42)),
            process_index=index, process_count=count)

    return (lambda: iter(data(batch_shard_index(), batch_shard_count()).train_dataloader),
            lambda: data(process_index(), process_count()).eval_dataloader, False)


def build_perceptual(config, logger, device) -> Optional[nn.Module]:
    """The configured perceptual loss as a frozen module on `device`, or None.

    Pretrained weights come from the JAX package's environment variables:
      MASKBIT_RESNET50_WEIGHTS  torchvision resnet50 state dict (.pth)
      MASKBIT_CONVNEXT_WEIGHTS  torchvision convnext_small state dict (.pth)
      MASKBIT_LPIPS_WEIGHTS     LPIPS lin heads (default: the shipped .msgpack)
      MASKBIT_VGG16_WEIGHTS     torchvision vgg16 state dict (.pth)
    Without them the loss is off, with the JAX package's warning (None);
    `losses.perceptual_loss: none` or a zero `losses.perceptual_weight`
    turn it off silently."""
    name = config.select("losses.perceptual_loss", "none")
    if name == "none" or config.select("losses.perceptual_weight", 0.0) == 0.0:
        return None
    if name in ("resnet50", "convnext_s"):
        from maskbit_tpu_torch.losses.perceptual import PerceptualLoss

        env = "MASKBIT_RESNET50_WEIGHTS" if name == "resnet50" else "MASKBIT_CONVNEXT_WEIGHTS"
        path = os.environ.get(env, "")
        if not os.path.exists(path):
            logger.warning(f"Perceptual backbone {name!r} weights unavailable "
                           f"({env}={path!r}); disabling perceptual loss.")
            return None
        module = PerceptualLoss(name, config.select("losses.perceptual_loss_on_logits", True))
        state = torch.load(path, map_location="cpu", weights_only=True)
        module.model.load_state_dict(state.get("state_dict", state), strict=True)
        return module.to(device).eval()
    if name == "lpips":
        from maskbit_tpu_torch.losses.lpips import load_lpips, lpips_weights

        lin_path, vgg_path, missing = lpips_weights()
        if missing:
            logger.warning(f"LPIPS weights unavailable ({', '.join(missing)}); "
                           "disabling perceptual loss.")
            return None
        return load_lpips(lin_path, vgg_path, device)
    raise ValueError(f"Perception loss {name} is not supported.")


def reset_optimizer_counts(opt):
    """Zero the optimizer's `count` and `mini_step` and keep its moments:
    the original repo's `resume_lr_scheduler: false` (the LR schedule and
    Adam's bias correction restart; optax's zeroing of `count`,
    `gradient_step` and `mini_step` in the JAX package)."""
    opt.count = opt.mini_step = 0
    return opt


class ProfilerHook:
    """A torch.profiler trace over a configured window of steps: CPU and,
    where there is a card, CUDA activities.

    `experiment.profile_steps="10-15"` (inclusive; "7" is one step) traces
    the steps that start with 10 to 15 steps done, as JAX's `ProfilerHook`,
    into <output_dir>/profile as one Chrome trace a process
    (`steps_10-15_rank0.json`). An empty or absent key does nothing. The
    train loop calls `step(steps_done)` before each step and `close()` on
    every exit, a SIGTERM stop included; a window still open is written
    then."""

    def __init__(self, output_dir: str, spec: str = ""):
        self.dir = os.path.join(output_dir, "profile")
        self._start = self._stop = None
        if spec:
            lo, _, hi = str(spec).partition("-")
            self._start, self._stop = int(lo), int(hi or lo)
        self._prof = None

    def step(self, global_step: int) -> None:
        if self._start is None:
            return
        if global_step == self._start and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
        elif global_step > self._stop and self._prof is not None:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        self._prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self._prof.export_chrome_trace(os.path.join(
            self.dir, f"steps_{self._start}-{self._stop}_rank{process_index()}.json"))
        self._prof = None


class GracefulShutdown:
    """Preemption-safe training: SIGTERM sets a flag; the train loop
    finishes the step in flight, sees `should_stop(step)`, writes a final
    blocking checkpoint and exits, so resume-latest continues from that
    step. `close()` puts the previous handler back.

    Across processes the final save is collective, so the stop decision is
    global: SIGTERM may reach only some processes, and a local decision
    would leave the others waiting in the next collective. `should_stop`
    therefore ORs the flag over the processes, on the steps divisible by
    `check_every` only (every process agrees on which steps from the global
    step; the reduction waits for every process, so it does not run every
    step). Once true it stays true; in one process it is immediate."""

    def __init__(self, logger=None, check_every: int = 8):
        self.requested = False
        self.check_every = max(1, int(check_every))
        self._stopped = False
        self._logger = logger
        try:
            self._prev = signal.signal(signal.SIGTERM, self._handle)
        except ValueError:  # not in the main thread: stay inert
            self._prev = None

    def _handle(self, signum, frame):
        self.requested = True
        if self._logger is not None:
            self._logger.warning("SIGTERM received — finishing the in-flight step, then "
                                 "writing a final checkpoint and exiting")

    def should_stop(self, step: int = 0) -> bool:
        """The global stop decision after global step `step`."""
        if self._stopped:
            return True
        if process_count() == 1:
            self._stopped = self.requested
        elif step % self.check_every == 0:
            self._stopped = bool(process_allgather_f64([float(self.requested)]).any())
        return self._stopped

    def close(self) -> None:
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
            self._prev = None


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

    def restart(self):
        """Start the next step's clock now: work between steps (generation,
        a save) is no step's time."""
        self._end = time.time()
