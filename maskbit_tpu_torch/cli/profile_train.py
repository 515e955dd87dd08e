"""Where one Stage-II train step's time goes: by phase and by kernel.

    python -m maskbit_tpu_torch.cli.profile_train \\
        config=configs/generator/maskbit_generator_14bit.yaml training.device=cuda \\
        experiment.vqgan_checkpoint= experiment.output_dir=build/profile_train

Builds the run as the training CLI does (`train_maskbit.build_training`:
checkpoint or seeded random tokenizer, JAX-style generator init, synthetic
batches without shards), takes 2 warm-up steps, then:
  * 3 steps on the host clock, each ended by a device synchronise;
  * 1 step with the device synchronised at the ends of each phase of the
    trainer (tokenize, forward, backward, optimizer, EMA: its
    `record_function` ranges), which gives the phases' wall times;
  * 1 step under torch.profiler: the device's busy time and share of the
    step, kernel time by category and the top kernels.
On a CPU device the "device" times are the CPU operators' self times.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict

import torch

from maskbit_tpu_torch.cli.train_maskbit import _logger, build_training, next_batch
from maskbit_tpu_torch.core.config import config_from_cli
from maskbit_tpu_torch.train import generator_trainer

# kernel-name fragment -> category, first match wins
_CATEGORIES = (
    ("attn_fwd_kernel", "dropout attention forward (hand)"),
    ("attn_fwd_tf32_kernel", "dropout attention forward (hand)"),
    ("attn_fwd_wide", "dropout attention forward (hand)"),
    ("attn_bwd", "dropout attention backward (hand)"),
    ("multi_tensor_apply", "optimizer, EMA, grad norm (foreach)"),
    ("conv", "tokenizer convolutions (cuDNN)"),
    ("implicit", "tokenizer convolutions (cuDNN)"),
    ("gemm", "cuBLAS GEMM (projections, FFN, head)"),  # float32 cuBLAS: sm80_xmma_gemm_*
    ("nvjet", "cuBLAS GEMM (projections, FFN, head)"),
    ("xmma", "tokenizer convolutions (cuDNN)"),
    ("layer_norm", "LayerNorm"),
    ("group_norm", "GroupNorm"),
    ("GroupNorm", "GroupNorm"),
    ("softmax", "softmax, log-softmax"),
    ("distribution", "random draws (dropout masks)"),
)


def category_of(kernel_name: str) -> str:
    for key, name in _CATEGORIES:
        if key in kernel_name:
            return name
    return "other (elementwise, casts, reductions, copies)"


def profile_steps(run) -> list[str]:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    on_cuda = run["device"].type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    state, step_fn, rng = run["state"], run["train_step"], run["rng"]

    def step():
        images, labels = next_batch(run)
        sync()
        t0 = time.perf_counter()
        step_fn(state, images, labels, rng)
        sync()
        return time.perf_counter() - t0

    for _ in range(2):
        step()
    walls = [step() for _ in range(3)]

    phases: dict[str, float] = defaultdict(float)

    class PhaseClock:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            sync()
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            sync()
            phases[self.name] += time.perf_counter() - self.t0

    real = generator_trainer.record_function
    generator_trainer.record_function = PhaseClock
    try:
        phased_wall = step()
    finally:
        generator_trainer.record_function = real

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    with profile(activities=activities) as prof:
        profiled_wall = step()
    # the trainer's ranges also appear on the device timeline, spanning the
    # kernels they launched: kept apart from the kernels
    if on_cuda:
        rows = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
                for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    else:
        rows = [(ev.self_cpu_time_total / 1e3, ev.count, ev.key) for ev in prof.key_averages()]
    spans = {key: ms for ms, _, key in rows if key.startswith("train/")}
    rows = [r for r in rows if not r[2].startswith("train/")]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    by_cat: dict[str, float] = defaultdict(float)
    for ms, _, name in rows:
        by_cat[category_of(name)] += ms

    b = run["batch_size"]
    wall_ms = sorted(walls)[1] * 1e3
    lines = [f"train step at batch {b} on {run['device']}: host-clock walls "
             f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms (median {wall_ms:.1f} ms = "
             f"{b / wall_ms * 1e3:.1f} samples/s); under the profiler {profiled_wall * 1e3:.1f} ms, "
             f"device busy {busy:.1f} ms = {100 * busy / (profiled_wall * 1e3):.1f}% of it, "
             f"{100 * busy / wall_ms:.1f}% of the median unprofiled step",
             f"phases, synchronised at each end (step {phased_wall * 1e3:.1f} ms):"]
    for name, sec in phases.items():
        lines.append(f"{sec * 1e3:10.2f} ms {100 * sec / phased_wall:5.1f}%  {name}")
    if spans:
        lines.append("phase spans on the device timeline (profiled step): " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in spans.items()))
    lines.append("device time by kernel category:")
    for name, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        lines.append(f"{ms:10.2f} ms {100 * ms / max(busy, 1e-9):5.1f}%  {name}")
    lines.append("top kernels:")
    for ms, count, name in rows[:20]:
        lines.append(f"  {ms:10.2f} ms x{count:6d}  {name[:110]}")
    return lines


def main(argv=None) -> list[str]:
    config = config_from_cli(argv if argv is not None else sys.argv[1:])
    lines = profile_steps(build_training(config, _logger()))
    print("\n".join(lines), flush=True)
    return lines


if __name__ == "__main__":
    main()
