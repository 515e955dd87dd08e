"""Where one sampler call's time goes: kernel time by layer under torch.profiler.

    python -m maskbit_tpu_torch.cli.profile_sampler \\
        config=configs/generator/maskbit_generator_14bit.yaml \\
        serve.batch_size=8 serve.device=cuda

Builds the server's `GeneratorService` (checkpoints or seeded random
weights, as `cli/serve.py`), warms it up, times one call at the fixed
batch without the profiler, then one under it. Prints the wall times, the
device's busy time and share, the time by layer and the top kernels, then
the profiler's own table. On a CPU device the "device" times are the CPU
operators' self times.
"""

from __future__ import annotations

import sys
import time

import torch

# kernel-name fragment -> layer, first match wins
_LAYERS = (
    ("gemm_bias_kernel", "attention block: projections (hand GEMM)"),
    ("attention_kernel", "attention block: attention (hand)"),
    ("layernorm_kernel", "attention block: LayerNorm (hand)"),
    ("conv", "decoder convolutions (cuDNN)"),
    ("xmma", "decoder convolutions (cuDNN)"),
    ("gemm", "cuBLAS GEMM (FFN, embeddings, head)"),
    ("nvjet", "cuBLAS GEMM (FFN, embeddings, head)"),
    ("sort", "sampler sort"),
    ("Sort", "sampler sort"),
)


def layer_of(kernel_name: str) -> str:
    for key, layer in _LAYERS:
        if key in kernel_name:
            return layer
    return "other (elementwise, norms, reductions, copies)"


def profile_call(service, labels, seed: int = 1) -> tuple[list[str], object]:
    """One unprofiled and one profiled `service.generate(labels, seed)`;
    returns (report lines, profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    on_cuda = service.device.type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    service.generate(labels, seed=seed)
    plain_wall = time.perf_counter() - t0
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        service.generate(labels, seed=seed)
        wall = time.perf_counter() - t0
    if on_cuda:
        rows = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
                for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    else:
        rows = [(ev.self_cpu_time_total / 1e3, ev.count, ev.key) for ev in prof.key_averages()]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    by_layer: dict[str, float] = {}
    for ms, _, name in rows:
        by_layer[layer_of(name)] = by_layer.get(layer_of(name), 0.0) + ms
    lines = [f"one sampler call, batch {len(labels)} on {service.device}: wall "
             f"{wall * 1e3:.1f} ms under the profiler ({plain_wall * 1e3:.1f} ms without); "
             f"device busy {busy:.1f} ms = {100 * busy / (wall * 1e3):.1f}% of wall"]
    for layer, ms in sorted(by_layer.items(), key=lambda kv: -kv[1]):
        lines.append(f"{ms:10.2f} ms {100 * ms / max(busy, 1e-9):5.1f}%  {layer}")
    for ms, count, name in rows[:20]:
        lines.append(f"  {ms:10.2f} ms x{count:6d}  {name[:110]}")
    return lines, prof


def main(argv=None) -> None:
    from maskbit_tpu.core.config import config_from_cli  # yaml only, no JAX
    from maskbit_tpu_torch.cli.serve import GeneratorService

    config = config_from_cli(argv if argv is not None else sys.argv[1:])
    service = GeneratorService(config)
    try:
        service.warmup()
        lines, prof = profile_call(service, list(range(service.batch)))
    finally:
        service.close()
    sort_by = "self_device_time_total" if service.device.type == "cuda" else "self_cpu_time_total"
    print("\n".join(lines) + "\n", flush=True)
    print(prof.key_averages().table(sort_by=sort_by, row_limit=60), flush=True)


if __name__ == "__main__":
    main()
