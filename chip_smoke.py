#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`maskbit_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py             # all phases, one card

Phases, each of which fails the run if it fails:
  1. device: require CUDA; print the card's name and power limit; switch
     TF32 off for the comparisons.
  2. build: compile the hand-written kernels from `maskbit_tpu_torch/csrc/`.
  3. kernels: the attention block kernel against its plain PyTorch version
     at the serving shapes (16, 257, 1024) and (2, 1025, 1024), 16 heads,
     with timings (CUDA events, median of 20 after warm-up) beside the plain
     version and the port's bf16 einsum path; then the flagship generator's
     logits (depth cut to 2) through the kernel against a float32
     plain-PyTorch forward of the same weights.
  4. slice: the port's HTTP server (`maskbit_tpu_torch.cli.serve.main`) on
     `configs/generator/maskbit_generator_14bit.yaml` (depth 24, hidden 1024,
     64 steps, CFG) at serve batch 8 with random weights; /healthz, a seeded
     /generate twice (byte-identical), two concurrent unseeded requests
     (micro-batched), one PNG; checks shapes, non-constant images and that
     every attention layer of every step launched the kernel.
Where one sampler call's time goes is `maskbit_tpu_torch.cli.profile_sampler`.
The next-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. Longer logs go to chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import io
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
CONFIG = os.path.join(ROOT, "configs", "generator", "maskbit_generator_14bit.yaml")
SERVE_BATCH = 8
HEADS = 16
# The kernel returns bf16; its plain version runs in float32 on the same
# bf16 inputs. Rounding the output to bf16 costs at most half an ulp:
# 2^-6 = 0.0156 for |y| in [4, 8), as far as a LayerNorm output of these
# inputs reaches. The bf16 roundings of qkv, the softmax weights and the
# head outputs (kept from the TPU kernel) add far less after the output
# projection. 3e-2 is about twice the output rounding.
KERNEL_ATOL = 3e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(torch) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs one card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else (
        f"nvidia-smi failed: {smi.stderr.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; device 0: {name}; "
        f"count {torch.cuda.device_count()}")
    log(card)
    log(f"[device] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return {"name": name, "card": card}


def phase_build() -> None:
    from maskbit_tpu_torch.nn import cuda_build

    t0 = time.perf_counter()
    cuda_build.load_library("attention_block")
    info = cuda_build.build_log["attention_block"]
    log(f"[build] attention_block: {time.perf_counter() - t0:.2f} s "
        f"({'cached' if info['cached'] else 'nvcc'})")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        f.write(info["ptxas"])
    for line in info["ptxas"].splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")


def _time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _block_inputs(torch, b, n, e, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev, bf16 = "cuda", torch.bfloat16

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    x = torch.nn.functional.layer_norm(rnd(b, n, e), (e,)).to(bf16)
    w_qkv = rnd(3 * e, e, std=0.02).to(bf16)  # torch (out, in) layout
    w_o = rnd(e, e, std=0.02).to(bf16)
    return dict(x=x, wqkv=w_qkv.t(), bqkv=rnd(3 * e, std=0.02), wo=w_o.t(), bo=rnd(e, std=0.02),
                ln_scale=1.0 + rnd(e, std=0.02), ln_bias=rnd(e, std=0.02))


def _einsum_block(torch, inp, e):
    """The port's plain bf16 attention block (`attention_impl: einsum`:
    cuBLAS projections, eager softmax) with the same weights."""
    from maskbit_tpu_torch.cli.common import build_module
    from maskbit_tpu_torch.nn.transformer import BertAttention

    blk = build_module(lambda: BertAttention(e, HEADS, attention_impl="einsum"), "cuda")
    with torch.no_grad():
        blk.mha.in_proj_weight.copy_(inp["wqkv"].t())
        blk.mha.in_proj_bias.copy_(inp["bqkv"])
        blk.mha.out_proj.weight.copy_(inp["wo"].t())
        blk.mha.out_proj.bias.copy_(inp["bo"])
        blk.norm.weight.copy_(inp["ln_scale"])
        blk.norm.bias.copy_(inp["ln_bias"])
    return blk.to(torch.bfloat16)


def phase_kernels(torch) -> dict:
    from maskbit_tpu_torch.nn import attention_block as ab

    rows, worst = [], 0.0
    for b, n in ((2 * SERVE_BATCH, 257), (2, 1025)):
        e = 1024
        inp = _block_inputs(torch, b, n, e, seed=b * n)
        got = ab.fused_attention_block(**inp, num_heads=HEADS)
        torch.cuda.synchronize()
        ref = ab.fused_attention_block_reference(
            **{k: v.float() for k, v in inp.items()}, num_heads=HEADS)
        err = (got.float() - ref).abs()
        max_err, mean_err = err.max().item(), err.mean().item()
        finite = bool(torch.isfinite(got).all())
        kernel_ms = _time_ms(torch, lambda: ab.fused_attention_block(**inp, num_heads=HEADS))
        plain_ms = _time_ms(torch, lambda: ab.fused_attention_block_reference(**inp, num_heads=HEADS))
        blk = _einsum_block(torch, inp, e)
        with torch.inference_mode():
            einsum_ms = _time_ms(torch, lambda: blk(inp["x"]))
        log(f"[kernel] attention_block x=({b}, {n}, {e}) h={HEADS}: max_abs_err {max_err:.6f} "
            f"mean_abs_err {mean_err:.3e} (atol {KERNEL_ATOL}) max|ref| {ref.abs().max().item():.3f}; "
            f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"einsum-path bf16 {einsum_ms:.4f} ms")
        if not finite or max_err > KERNEL_ATOL:
            raise AssertionError(f"attention_block disagrees at ({b}, {n}, {e}): "
                                 f"max_abs_err {max_err} > {KERNEL_ATOL} or non-finite")
        rows.append(dict(shape=[b, n, e], max_abs_err=max_err, mean_abs_err=mean_err,
                         ms=kernel_ms, plain_ms=plain_ms, einsum_ms=einsum_ms))
        worst = max(worst, max_err)
    return {"rows": rows, "max_abs_err": worst}


def _flagship() -> dict:
    """The flagship config's `model` node (plain YAML, no interpolation)."""
    import yaml

    with open(CONFIG) as f:
        return yaml.safe_load(f)["model"]


def phase_generator(torch) -> None:
    """Flagship-width LFQBert, depth cut to 2: logits through the kernel
    (bf16) against a float32 plain forward of the same weights."""
    from maskbit_tpu_torch.cli.common import build_module, random_init_
    from maskbit_tpu_torch.models.generator import LFQBert

    model = _flagship()
    mlm, vq = dict(model["mlm_model"], depth=2), model["vq_model"]
    fused = build_module(lambda: LFQBert.from_config(mlm, vq, dtype=torch.bfloat16), "cuda")
    random_init_(fused, torch.Generator(device="cuda").manual_seed(1))
    plain = build_module(
        lambda: LFQBert.from_config(dict(mlm, attention_impl="einsum"), vq), "cuda")
    plain.load_state_dict(fused.state_dict(), strict=True)
    fused.to(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(2)
    b = 4
    tokens = torch.randint(0, fused.mask_token + 1, (b, fused.seq_len, fused.codebook_splits),
                           generator=g, device="cuda", dtype=torch.int32)
    labels = torch.randint(0, 1000, (b,), generator=g, device="cuda")
    drop = torch.tensor([False, True, False, True], device="cuda")
    with torch.inference_mode():
        got = fused(tokens, labels, drop).float()
        ref = plain(tokens, labels, drop)
    rel = ((got - ref).norm() / ref.norm()).item()
    log(f"[kernel] generator logits (depth 2, bf16 kernel vs f32 plain): shape "
        f"{tuple(got.shape)}, relative error {rel:.3e}, max|ref| {ref.abs().max().item():.3f}")
    # bf16 keeps 8 significant bits (relative rounding 2^-9 ~ 2e-3); a
    # few roundings per layer over 2 layers and the head stay near 1e-2.
    if not torch.isfinite(got).all() or rel > 3e-2:
        raise AssertionError(f"generator logits disagree: relative error {rel}")


def _post(base, body, timeout=900):
    req = urllib.request.Request(f"{base}/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        data = r.read()
    return data, time.perf_counter() - t0


def _images(data):
    import numpy as np

    return np.load(io.BytesIO(data))["images"]


def _check_images(imgs, n):
    import numpy as np

    if imgs.shape != (n, 256, 256, 3) or imgs.dtype != np.uint8:
        raise AssertionError(f"bad images {imgs.shape} {imgs.dtype}")
    for i, img in enumerate(imgs):
        if img.min() == img.max():
            raise AssertionError(f"image {i} is constant")


def phase_slice(torch, device_info) -> dict:
    from maskbit_tpu_torch.cli.serve import main
    from maskbit_tpu_torch.nn import attention_block as ab

    mlm = _flagship()["mlm_model"]
    depth, steps = int(mlm["depth"]), int(mlm["num_steps"])
    argv = [f"config={CONFIG}", f"serve.batch_size={SERVE_BATCH}", "serve.port=0",
            "serve.device=cuda", "experiment.vqgan_checkpoint=", "experiment.generator_checkpoint="]
    ab.launches = 0
    t0 = time.perf_counter()
    server, service = main(argv, serve_forever=False)
    startup = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if not (health["status"] == "ok" and health["warm"]):
            raise AssertionError(f"bad /healthz {health}")

        labels = [1, 7, 282]
        d1, t1 = _post(base, {"labels": labels, "seed": 5})
        d2, t2 = _post(base, {"labels": labels, "seed": 5})
        a, b = _images(d1), _images(d2)
        _check_images(a, 3)
        if a.tobytes() != b.tobytes():
            raise AssertionError("seeded repeats differ")

        calls_before = service.device_calls
        results, errors, times = [None, None], [], [None, None]

        def hit(i):
            try:
                data, dt = _post(base, {"labels": [100 + i]})
                results[i], times[i] = _images(data), dt
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        if errors:
            raise AssertionError(f"concurrent requests failed: {errors}")
        for imgs in results:
            _check_images(imgs, 1)
        batched_calls = service.device_calls - calls_before

        png, t_png = _post(base, {"labels": [3, 4], "format": "png"})
        if png[:8] != b"\x89PNG\r\n\x1a\n":
            raise AssertionError("bad png")
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    torch.cuda.synchronize()
    launches = ab.launches
    expected = depth * steps * service.device_calls
    log(f"[slice] startup (random init + warm-up call) {startup:.2f} s; device calls "
        f"{service.device_calls}; concurrent unseeded requests took {batched_calls} call(s)")
    log(f"[slice] seeded 3-label requests {t1:.3f} s, {t2:.3f} s ({3 / t2:.3f} img/s); "
        f"concurrent 1-label {times[0]:.3f} s, {times[1]:.3f} s; png {t_png:.3f} s; "
        f"one call = {SERVE_BATCH} images in {t2:.3f} s = {SERVE_BATCH / t2:.3f} img/s "
        f"at serve batch {SERVE_BATCH} [{device_info['card']}]")
    log(f"[slice] attention_block launches {launches} == depth {depth} x steps {steps} x "
        f"device calls {service.device_calls} = {expected}")
    if batched_calls > 2:
        raise AssertionError(f"no micro-batching: {batched_calls} calls for 2 requests")
    if launches != expected:
        raise AssertionError(f"attention_block launched {launches} times, expected {expected}")
    return {"launches": launches, "request_s": t2, "img_per_s": SERVE_BATCH / t2}


def main() -> int:
    import torch

    sys.path.insert(0, ROOT)
    import maskbit_tpu_torch  # noqa: F401 — fails when run outside the checkout

    device_info = phase_device(torch)
    phase_build()
    kern = phase_kernels(torch)
    phase_generator(torch)
    sl = phase_slice(torch, device_info)
    main_row = kern["rows"][0]
    record = {"kernels": [{
        "name": "fused_attention_block",
        "route": "cuda",
        "source": "maskbit_tpu_torch/csrc/attention_block.cu",
        "replaces": "maskbit_tpu/nn/pallas_attention.py:532",
        "launches": sl["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
    }]}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "result.json"), "w") as f:
        json.dump({"device": device_info, "kernel_rows": kern["rows"], "slice": sl}, f, indent=1)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
