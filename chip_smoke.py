#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`maskbit_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py             # all phases, one card

Phases, each of which fails the run if it fails:
  1. device: require CUDA; print the card's name and power limit; switch
     TF32 off for the comparisons.
  2. build: compile the hand-written kernels from `maskbit_tpu_torch/csrc/`,
     one nvcc per source, all started together.
  3. kernels: the attention block's chain of kernels against its plain
     PyTorch version at the serving shapes (16, 257, 1024) and (2, 1025,
     1024) and the eval shape (200, 257, 1024), 16 heads, bf16 vectors as
     the serving generator stores them,
     timed kernel by kernel beside the plain version, the port's bf16 einsum
     path and the library chain (cuBLAS QKV projection,
     `scaled_dot_product_attention`, cuBLAS out-projection plus the
     residual, `F.layer_norm`), and every block-row alternative of the
     wrapper's plan side by side; the
     dropout-attention forward and backward kernels (rate 0.1) against their
     plain versions at the training shapes (32, 257, 16, 64) and (8, 1025,
     16, 64), the kernel's keep mask (read out at zero logits) against the
     plain version's bit for bit, and the dropout-free `fused_attention` at
     (16, 257, 16, 64), each timed beside its plain version and
     `scaled_dot_product_attention`; then the flagship generator's logits
     (depth cut to 2) through the kernel against a float32 plain-PyTorch
     forward of the same weights. Every time is taken twice: `ms`, the
     device time per call (the kernels' device times under torch.profiler,
     summed over 50 calls), and `call_ms`, one call's CUDA-event time
     (median of 20), which includes the host work before its first kernel.
  4. serve slice: the port's HTTP server (`maskbit_tpu_torch.cli.serve.main`)
     on `configs/generator/maskbit_generator_14bit.yaml` (depth 24, hidden
     1024, 64 steps, CFG) at serve batch 8 with random weights; /healthz, a
     seeded /generate twice (byte-identical), two concurrent unseeded
     requests (micro-batched), one PNG; checks shapes, non-constant images
     and that every attention layer of every step launched the block (and
     with it the `fused_attention` forward kernel).
  5. train check: one MLM train step of the flagship-width LFQBert cut to
     depth 2 with the kernels in bf16 on the card, against the same step
     with the plain versions in float32 on the CPU (same weights, tokens and
     injected draws; hidden dropout off, attention dropout 0.1): the loss
     and the global grad norm agree.
  6. train slice: `maskbit_tpu_torch.cli.train_maskbit.main` on the same
     config at full width and depth, per-device batch 32, 6 steps, random
     tokenizer, synthetic data: finite losses, depth x steps launches of
     each dropout-attention kernel, and the saved `.bin` weights load back
     strictly; median step time, samples/s and peak memory.
  7. train from data, same config, full width and depth, batch 32:
     a. `cli.pretokenize.tokenize_to_shards` on 256 synthetic 256 px images
        (numpy, no PIL) into token shards; tokens per second;
     b. `train_maskbit.main` from those shards, 6 steps, `save_every=3`,
        `generate_every=3`: finite losses, the dropout kernels on every
        layer of every step, and each generation (the sampler with the EMA
        weights) through the attention block on every layer of every
        sampling step; median step and samples/s beside phase 6's; the
        saves' times;
     c. resume: `main` again with `max_train_steps` raised to 8 logs
        `resumed from step 6`, the restored parameters, moments, EMA and
        counts equal bit for bit a host copy taken before the step-6 save,
        and the two further steps have finite losses; the restore's time;
     d. remat: the 512 px config (batch 8, random tokens of its shape), one
        step from one generator seed with `remat` off and one with it on:
        loss, per-parameter gradient norms and updated parameters equal bit
        for bit, the recompute's second dropout-forward launch per layer;
        peak memory and device time of a step for both.
  8. eval, the flagship (depth 24, hidden 1024, 64 steps, guidance 7.1
     cosine, bf16) and the 14-bit and VQ 12-bit tokenizers, random weights:
     a. random pt-fid-layout Inception weights from a seed, saved as a
        `.pth` under build/chip_smoke_data/ and named by
        MASKBIT_INCEPTION_WEIGHTS; `resize_bilinear_tf1` on the card bit for
        bit against its numpy replica at 256 -> 299; the card's float32
        Inception features of 8 images against the CPU's (and, for
        information, the gap with TF32 allowed);
     b. 512 synthetic 256 px images written as tar shards
        (`data/shard_writer`), then `cli.make_stats.main` over them;
     c. `cli.eval_maskbit.main` at eval.total_samples=1000,
        eval.batch_size=100 (a CFG batch of 200 x 257 rows through the
        attention block on every layer of every step) against those stats:
        1000 samples scored, finite FID and IS, and depth x steps x 10
        batches launches of the block; img/s and per batch the sampler, the
        Inception and the host float64 times;
     d. `cli.eval_tokenizer.main` on maskbit_tokenizer_14bit.yaml (LFQ) and
        vqgan_plus_12bit.yaml (VQ) over the shards, 4 batches: every metric
        finite.
     The attention block is also held at the eval shape (200, 257, 1024)
     in phase 3.
  9. tokenizer train (Stage I), which launches none of the four kernels:
     a. TF32 allowed: the streamed LFQ entropy at the 14-bit flagship's
        shape (4096 rows, 16,384 codes) on the card, both global TF32 flags
        on, against the CPU (terms rel 1e-4, gradient 1e-3 of its max); one
        float32 Stage-I step of a 64 px tokenizer with the discriminator
        and adaptive weight live, TF32 allowed for matrix products (cuDNN's
        convolutions in float32), against the same step on the CPU (every
        loss and metric rel 1e-3); each also without the entropy's own
        full-f32 scope, for information;
     b. with PyTorch's default TF32 flags (cuDNN's on: the float32
        ResNet-50; matrix products' off), as a user's run:
        `cli.train_tokenizer.main` on maskbit_tokenizer_14bit.yaml (hidden
        128, 14-bit LFQ, VQGAN+ discriminator, ResNet-50 perceptual loss
        from random torchvision-layout weights named by
        MASKBIT_RESNET50_WEIGHTS, bf16, batch 16, 256 px, synthetic data),
        6 steps with the discriminator from step 3, `save_every=3`,
        `generate_every=3`, `eval_every=6` over 2 batches: finite losses,
        a non-zero perceptual loss on every step, the gate where it was
        set; median step before and after the gate, samples/s, peak memory,
        the saves' time in the loop; then a resume to step 8 (the restored
        state equal bit for bit to a host copy taken before the step-6
        save; the restore's time), and `cli.eval_tokenizer` on
        ema_model-8.bin with LPIPS (the shipped lin heads, random VGG16);
     c. one step's device time by kernel category (torch.profiler), and the
        ResNet-50 loss and the entropy timed alone;
     d. maskbit_tokenizer_18bit.yaml (262,144 codes): one step's time and
        peak memory, the entropy's forward and backward alone.
Where one sampler call's time goes is `maskbit_tpu_torch.cli.profile_sampler`.
The next-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. Longer logs go to chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
CONFIG = os.path.join(ROOT, "configs", "generator", "maskbit_generator_14bit.yaml")
CONFIG_512 = os.path.join(ROOT, "configs", "generator", "maskbit_generator_14bit_512.yaml")
SERVE_BATCH = 8
HEADS = 16
# The kernel returns bf16; its plain version runs in float32 on the same
# bf16 inputs. Rounding the output to bf16 costs at most half an ulp:
# 2^-6 = 0.0156 for |y| in [4, 8), as far as a LayerNorm output of these
# inputs reaches. The bf16 roundings of qkv, the softmax weights and the
# head outputs (kept from the TPU kernel) add far less after the output
# projection. 3e-2 is about twice the output rounding.
KERNEL_ATOL = 3e-2
# The dropout-attention kernels return bf16; their plain versions run in
# float32 on the same bf16 inputs with the same rounding points. Outputs and
# gradients of magnitude below 2 round to bf16 within 2^-8 = 0.0039; the
# online softmax rounds unnormalised weights (the TPU kernel normalised
# ones, one more bf16 rounding, relative 2^-9) and the backward's
# delta = rowsum(g * out) reads the bf16 output. 2e-2 (scaled by the largest
# reference value where that exceeds 1) covers these with room.
DROPOUT_ATOL = 2e-2
RATE = 0.1
TRAIN_BATCH, TRAIN_STEPS = 32, 6
PRETOKENIZE_IMAGES = 256
SAVE_EVERY, RESUME_STEPS = 3, 8
# the 512 px config's per-device batch (maskbit_generator_14bit_512.yaml)
LONG_BATCH = 8
# eval_maskbit's default batch; 1000 samples = 10 batches
EVAL_BATCH, EVAL_SAMPLES, STATS_IMAGES, EVAL_TOKENIZER_BATCHES = 100, 1000, 512, 4
TOKENIZER_CONFIGS = tuple(os.path.join(ROOT, "configs", "tokenizer", name)
                          for name in ("maskbit_tokenizer_14bit.yaml", "vqgan_plus_12bit.yaml"))
TOKENIZER_18 = os.path.join(ROOT, "configs", "tokenizer", "maskbit_tokenizer_18bit.yaml")
# phase 9: Stage-I steps, the discriminator's gate, saves, eval batches, the resume
TOK_STEPS, TOK_GATE, TOK_SAVE, TOK_EVAL_BATCHES, TOK_RESUME = 6, 3, 3, 2, 8
# H100 SXM data sheet: bf16 dense tensor-core peak and HBM3 bandwidth.
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12


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

    names = ["attention_block", "dropout_attention"]
    errors = []

    def build(name):
        try:
            cuda_build.load_library(name)
        except Exception as e:  # surfaced below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(name,)) for name in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    os.makedirs(OUT_DIR, exist_ok=True)
    for name in names:
        info = cuda_build.build_log[name]
        log(f"[build] {name}: {info['seconds']:.2f} s ({'cached' if info['cached'] else 'nvcc'}), "
            f"all builds {time.perf_counter() - t0:.2f} s")
        with open(os.path.join(OUT_DIR, f"ptxas_{name}.txt"), "w") as f:
            f.write(info["ptxas"])
        for line in info["ptxas"].splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "wgmma")):
                log(f"[build] ptxas: {line.strip()}")


def _bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: operations at the bf16 peak or
    bytes at the memory rate, whichever is longer."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def _time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """One call's time by CUDA events, median of `iters`: the start event
    is recorded before the Python call, so it includes the host work that
    runs before the first kernel reaches the stream (`call_ms`)."""
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


def _host_ms(torch, fn, iters: int = 100, warmup: int = 3) -> float:
    """The host's time to enqueue one call, median of `iters` (the card is
    synchronised before each, so the queue never fills): the wrapper's
    checks, allocations and launches, without the device's time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _device_breakdown(torch, fn, iters: int = 50, warmup: int = 3) -> dict:
    """Device time per call of each CUDA kernel (and memset or copy) that
    `iters` calls of fn launched under torch.profiler: its summed
    `self_device_time_total` over `iters`, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = {ev.key: ev.self_device_time_total / 1e3 / iters for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA}
    if sum(times.values()) <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return times


def _device_ms(torch, fn, iters: int = 50, warmup: int = 3) -> float:
    """Device time per call (`ms`): the sum of `_device_breakdown`. Host
    work between kernels is not counted."""
    return sum(_device_breakdown(torch, fn, iters, warmup).values())


def _kernel_name(key: str) -> str:
    """A profiler kernel name without its return type, namespace and
    parameters: `proj_kernel<128, 0>`."""
    return key.replace("(anonymous namespace)::", "").split("(")[0].replace("void ", "")


def _times(torch, fn, plain=None, library=None) -> dict:
    """`ms` (device) and `call_ms` (events) of fn; `plain_ms` and
    `library_ms` (device) of the plain version and the library call."""
    out = {"ms": _device_ms(torch, fn), "call_ms": _time_ms(torch, fn)}
    if plain is not None:
        out["plain_ms"] = _device_ms(torch, plain)
    if library is not None:
        out["library_ms"] = _device_ms(torch, library)
    return out


def _block_inputs(torch, b, n, e, seed, vectors):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev, bf16 = "cuda", torch.bfloat16

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    x = torch.nn.functional.layer_norm(rnd(b, n, e), (e,)).to(bf16)
    w_qkv = rnd(3 * e, e, std=0.02).to(bf16)  # torch (out, in) layout
    w_o = rnd(e, e, std=0.02).to(bf16)
    return dict(x=x, wqkv=w_qkv.t(), bqkv=rnd(3 * e, std=0.02).to(vectors), wo=w_o.t(),
                bo=rnd(e, std=0.02).to(vectors), ln_scale=(1.0 + rnd(e, std=0.02)).to(vectors),
                ln_bias=rnd(e, std=0.02).to(vectors))


def _library_chain(torch, inp, heads):
    """The block as a chain of library calls on the same bf16 weights:
    cuBLAS QKV projection, `scaled_dot_product_attention`, cuBLAS
    out-projection plus the residual, `F.layer_norm` (the yardstick: no one
    PyTorch call computes the block)."""
    F = torch.nn.functional
    x = inp["x"]
    b, n, e = x.shape
    w_qkv, w_o = inp["wqkv"].t(), inp["wo"].t()
    bqkv, bo, g, beta = (inp[k].to(torch.bfloat16) for k in ("bqkv", "bo", "ln_scale", "ln_bias"))

    def run():
        q, k, v = F.linear(x, w_qkv, bqkv).view(b, n, 3, heads, e // heads).permute(
            2, 0, 3, 1, 4).unbind(0)
        a = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, n, e)
        return F.layer_norm(F.linear(a, w_o, bo) + x, (e,), g, beta, 1e-12)

    return run


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

    # the serving generator stores its vectors in bf16; a parent tree's
    # wrapper (--tree) takes f32 ones only
    vectors = torch.bfloat16 if hasattr(ab, "VECTOR_DTYPES") else torch.float32
    rows, worst = [], 0.0
    for b, n in ((2 * SERVE_BATCH, 257), (2, 1025), (2 * EVAL_BATCH, 257)):
        e = 1024
        inp = _block_inputs(torch, b, n, e, seed=b * n, vectors=vectors)
        got = ab.fused_attention_block(**inp, num_heads=HEADS)
        torch.cuda.synchronize()
        ref = ab.fused_attention_block_reference(
            **{k: v.float() for k, v in inp.items()}, num_heads=HEADS)
        err = (got.float() - ref).abs()
        max_err, mean_err = err.max().item(), err.mean().item()
        finite = bool(torch.isfinite(got).all())
        block = lambda: ab.fused_attention_block(**inp, num_heads=HEADS)  # noqa: E731
        chain = {_kernel_name(k): v for k, v in _device_breakdown(torch, block).items()}
        t = {"ms": sum(chain.values()), "call_ms": _time_ms(torch, block),
             "host_ms": _host_ms(torch, block),
             "plain_ms": _device_ms(torch, lambda: ab.fused_attention_block_reference(
                 **inp, num_heads=HEADS))}
        library = _library_chain(torch, inp, HEADS)
        lib_err = (library().float() - ref).abs().max().item()
        library_chain_ms = _device_ms(torch, library)
        blk = _einsum_block(torch, inp, e)
        with torch.inference_mode():
            einsum_ms = _device_ms(torch, lambda: blk(inp["x"]))
        log(f"[kernel] attention_block x=({b}, {n}, {e}) h={HEADS}, {vectors} vectors: max_abs_err "
            f"{max_err:.6f} mean_abs_err {mean_err:.3e} (atol {KERNEL_ATOL}) max|ref| "
            f"{ref.abs().max().item():.3f}; kernels {t['ms']:.4f} ms device ({t['call_ms']:.4f} ms "
            f"per call by events, call - device {t['call_ms'] - t['ms']:.4f}; host enqueue "
            f"{t['host_ms']:.4f}), plain "
            f"{t['plain_ms']:.4f} ms, einsum-path bf16 {einsum_ms:.4f} ms, library chain "
            f"{library_chain_ms:.4f} ms (its max_abs_err {lib_err:.6f})")
        log("[kernel]   chain, device ms per call: " + "; ".join(
            f"{k} {v:.4f}" for k, v in chain.items()))
        variants = {}
        planned = None
        if hasattr(ab, "plan"):  # every block-row choice of the two projections, side by side
            for tiles in ((128, 128), (64, 64), (128, 64), (64, 128)):
                variants[str(tiles)] = _device_ms(torch, lambda: ab._launch(
                    **inp, num_heads=HEADS, eps=1e-12, tiles=tiles))
            planned = ab.plan(b * n, e, torch.cuda.get_device_properties(0).multi_processor_count)
            log(f"[kernel]   plan {planned}; (QKV rows, out rows) -> device ms: " + "; ".join(
                f"{k} {v:.4f}" for k, v in variants.items()))
        if not finite or max_err > KERNEL_ATOL:
            raise AssertionError(f"attention_block disagrees at ({b}, {n}, {e}): "
                                 f"max_abs_err {max_err} > {KERNEL_ATOL} or non-finite")
        flops = 2 * b * n * e * 3 * e + 2 * b * n * e * e + 4 * b * HEADS * n * n * (e // HEADS)
        # x, out and the weights bf16, the vectors in their dtype
        nbytes = 2 * (2 * b * n * e + 4 * e * e) + inp["bo"].element_size() * 6 * e
        rows.append(dict(shape=[b, n, e], max_abs_err=max_err, mean_abs_err=mean_err,
                         einsum_ms=einsum_ms, library_chain_ms=library_chain_ms, chain=chain,
                         variants=variants, plan=planned, **t, **_bound(flops, nbytes)))
        del inp, got, ref, err, blk
        worst = max(worst, max_err)
    return {"rows": rows, "max_abs_err": worst}


def _qkv_packed(torch, b, n, h, seed):
    """bf16 q, k, v as the QKV projection's views of one (b, n, 3, h, 64)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, n, 3, h, 64, generator=g, device="cuda").to(torch.bfloat16)
    return qkv.unbind(2)


def _sdpa(torch, q, k, v, dropout_p):
    """torch's fused attention on the (b, h, n, d) views: the yardstick."""
    f = torch.nn.functional.scaled_dot_product_attention
    return f(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), dropout_p=dropout_p)


def kernel_keep_mask(torch, da, seeds, b, n, h):
    """The forward kernel's keep mask, read out exactly: at zero logits every
    kept weight is positive and every dropped one 0, so with V one-hot over
    the head dim for 64 keys at a time, out[b, i, h, d] > 0 iff key
    (chunk + d) is kept for query i."""
    z = torch.zeros(b, n, h, 64, device="cuda", dtype=torch.bfloat16)
    seeds32 = da.seeds_as_int32(seeds, (b, h))
    keep = torch.empty(b, h, n, n, device="cuda", dtype=torch.bool)
    for c0 in range(0, n, 64):
        m = min(64, n - c0)
        v = torch.zeros_like(z)
        v[:, c0:c0 + m, :, :m] = torch.eye(m, device="cuda", dtype=torch.bfloat16)[:, None, :]
        out = da.launch_forward(z, z, v, seeds32, RATE)[0]
        keep[..., c0:c0 + m] = (out[..., :m] > 0).permute(0, 2, 1, 3)
    return keep


def phase_dropout_kernels(torch) -> dict:
    """The dropout-attention forward and backward kernels and the
    dropout-free `fused_attention` against their plain versions."""
    from maskbit_tpu_torch.nn import dropout_attention as da

    rows = {"dropout_attention_fwd": [], "dropout_attention_bwd": [], "fused_attention": []}
    for b, n in ((TRAIN_BATCH, 257), (LONG_BATCH, 1025)):
        h = HEADS
        q, k, v = _qkv_packed(torch, b, n, h, seed=b * n)
        seeds = torch.randint(0, 2**32, (b, h), generator=torch.Generator(device="cuda").manual_seed(n),
                              device="cuda", dtype=torch.int64)
        seeds32 = da.seeds_as_int32(seeds, (b, h))
        g = torch.randn(b, n, h, 64, generator=torch.Generator(device="cuda").manual_seed(n + 1),
                        device="cuda").to(torch.bfloat16)
        out, lse = da.launch_forward(q, k, v, seeds32, RATE)
        dq, dk, dv = da.launch_backward(q, k, v, out, lse, g, seeds32, RATE)
        torch.cuda.synchronize()
        qf, kf, vf = q.float(), k.float(), v.float()
        ref = da.dropout_attention_reference(qf, kf, vf, seeds, RATE)
        rdq, rdk, rdv = da.dropout_attention_backward_reference(qf, kf, vf, g.float(), seeds, RATE)
        fwd_err = (out.float() - ref).abs().max().item()
        bwd_errs = [(x.float() - r).abs().max().item() for x, r in ((dq, rdq), (dk, rdk), (dv, rdv))]
        bwd_tol = DROPOUT_ATOL * max(1.0, max(r.abs().max().item() for r in (rdq, rdk, rdv)))
        # the mask alone, bit for bit against the plain version's
        mask_flips = int((kernel_keep_mask(torch, da, seeds, b, n, h)
                          != da.hash_keep_mask(seeds, n, RATE)).sum().item())
        finite = all(bool(torch.isfinite(x).all()) for x in (out, dq, dk, dv))
        del ref, rdq, rdk, rdv, qf, kf, vf

        fwd_t = _times(torch, lambda: da.launch_forward(q, k, v, seeds32, RATE),
                       plain=lambda: da.dropout_attention_reference(q, k, v, seeds, RATE),
                       library=lambda: _sdpa(torch, q, k, v, RATE))
        ql, kl, vl = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
        lib_out = _sdpa(torch, ql, kl, vl, RATE)
        lib_g = g.transpose(1, 2)
        bwd_t = _times(
            torch, lambda: da.launch_backward(q, k, v, out, lse, g, seeds32, RATE),
            plain=lambda: da.dropout_attention_backward_reference(q, k, v, g, seeds, RATE),
            library=lambda: torch.autograd.grad(lib_out, (ql, kl, vl), lib_g, retain_graph=True))
        both_t = _times(torch, lambda: torch.autograd.grad(
            da.dropout_attention(ql, kl, vl, seeds, RATE), (ql, kl, vl), g),
            library=lambda: torch.autograd.grad(_sdpa(torch, ql, kl, vl, RATE), (ql, kl, vl), lib_g))
        del lib_out, ql, kl, vl

        elems = b * n * h * 64
        fwd_bound = _bound(4 * b * h * n * n * 64, 2 * 4 * elems + 4 * b * h * n)
        bwd_bound = _bound(10 * b * h * n * n * 64, 2 * 8 * elems + 4 * b * h * n)
        log(f"[kernel] dropout_attention ({b}, {n}, {h}, 64) rate {RATE}: fwd max_abs_err "
            f"{fwd_err:.6f}, dq/dk/dv {bwd_errs[0]:.6f}/{bwd_errs[1]:.6f}/{bwd_errs[2]:.6f} "
            f"(atol {DROPOUT_ATOL}, bwd {bwd_tol:.4f}); kernel keep mask vs plain: "
            f"{mask_flips} of {b * h * n * n} bits differ")
        log(f"[kernel]   device ms: fwd {fwd_t['ms']:.4f} (per call by events "
            f"{fwd_t['call_ms']:.4f}; plain {fwd_t['plain_ms']:.4f}, sdpa {fwd_t['library_ms']:.4f}, "
            f"bound {fwd_bound['bound_ms']:.4f} by {fwd_bound['bound_by']}); bwd {bwd_t['ms']:.4f} "
            f"(per call {bwd_t['call_ms']:.4f}; plain {bwd_t['plain_ms']:.4f}, sdpa bwd "
            f"{bwd_t['library_ms']:.4f}, bound {bwd_bound['bound_ms']:.4f} by "
            f"{bwd_bound['bound_by']}); fwd + bwd through autograd {both_t['ms']:.4f} (per call "
            f"{both_t['call_ms']:.4f}; sdpa {both_t['library_ms']:.4f})")
        if not finite or fwd_err > DROPOUT_ATOL or max(bwd_errs) > bwd_tol or mask_flips:
            raise AssertionError(f"dropout_attention disagrees at ({b}, {n}, {h}, 64)")
        rows["dropout_attention_fwd"].append(dict(
            shape=[b, n, h, 64], max_abs_err=fwd_err, mask_flips=mask_flips, **fwd_t,
            **fwd_bound))
        rows["dropout_attention_bwd"].append(dict(
            shape=[b, n, h, 64], max_abs_err=max(bwd_errs), **bwd_t, fwd_bwd_ms=both_t["ms"],
            fwd_bwd_call_ms=both_t["call_ms"], library_fwd_bwd_ms=both_t["library_ms"],
            **bwd_bound))
        del q, k, v, g, out, lse, dq, dk, dv

    b, n, h = 2 * SERVE_BATCH, 257, HEADS
    q, k, v = _qkv_packed(torch, b, n, h, seed=5)
    got = da.fused_attention(q, k, v)
    torch.cuda.synchronize()
    err = (got.float() - da.fused_attention_reference(q.float(), k.float(), v.float())
           ).abs().max().item()
    t = _times(torch, lambda: da.fused_attention(q, k, v),
               plain=lambda: da.fused_attention_reference(q, k, v),
               library=lambda: _sdpa(torch, q, k, v, 0.0))
    bound = _bound(4 * b * h * n * n * 64, 2 * 4 * b * n * h * 64)
    log(f"[kernel] fused_attention ({b}, {n}, {h}, 64): max_abs_err {err:.6f} (atol "
        f"{DROPOUT_ATOL}); device {t['ms']:.4f} ms (per call by events {t['call_ms']:.4f}; plain "
        f"{t['plain_ms']:.4f}, sdpa {t['library_ms']:.4f}, bound {bound['bound_ms']:.4f} by "
        f"{bound['bound_by']})")
    if not bool(torch.isfinite(got).all()) or err > DROPOUT_ATOL:
        raise AssertionError(f"fused_attention disagrees: max_abs_err {err}")
    rows["fused_attention"].append(dict(shape=[b, n, h, 64], max_abs_err=err, **t, **bound))
    return rows


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
    from maskbit_tpu_torch.nn import dropout_attention as da

    mlm = _flagship()["mlm_model"]
    depth, steps = int(mlm["depth"]), int(mlm["num_steps"])
    argv = [f"config={CONFIG}", f"serve.batch_size={SERVE_BATCH}", "serve.port=0",
            "serve.device=cuda", "experiment.vqgan_checkpoint=", "experiment.generator_checkpoint="]
    ab.launches = 0
    for key in da.launches:
        da.launches[key] = 0
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
    fused_launches = da.launches["fused_attention"]  # the block's attention forward
    expected = depth * steps * service.device_calls
    log(f"[slice] startup (random init + warm-up call) {startup:.2f} s; device calls "
        f"{service.device_calls}; concurrent unseeded requests took {batched_calls} call(s)")
    log(f"[slice] seeded 3-label requests {t1:.3f} s, {t2:.3f} s ({3 / t2:.3f} img/s); "
        f"concurrent 1-label {times[0]:.3f} s, {times[1]:.3f} s; png {t_png:.3f} s; "
        f"one call = {SERVE_BATCH} images in {t2:.3f} s = {SERVE_BATCH / t2:.3f} img/s "
        f"at serve batch {SERVE_BATCH} [{device_info['card']}]")
    log(f"[slice] attention_block launches {launches} == depth {depth} x steps {steps} x "
        f"device calls {service.device_calls} = {expected}; fused_attention launches "
        f"{fused_launches}")
    if batched_calls > 2:
        raise AssertionError(f"no micro-batching: {batched_calls} calls for 2 requests")
    if launches != expected:
        raise AssertionError(f"attention_block launched {launches} times, expected {expected}")
    return {"launches": launches, "fused_attention_launches": fused_launches, "request_s": t2,
            "img_per_s": SERVE_BATCH / t2}


def phase_train_check(torch) -> dict:
    """One MLM train step of the flagship-width LFQBert (depth 2) with the
    kernels in bf16 on the card against the same step with the plain
    versions in float32 on the CPU."""
    import numpy as np

    from maskbit_tpu_torch.cli.common import build_module
    from maskbit_tpu_torch.losses.mlm import MLMLossConfig
    from maskbit_tpu_torch.models.generator import LFQBert, init_generator_weights_
    from maskbit_tpu_torch.nn import dropout_attention as da
    from maskbit_tpu_torch.train.generator_trainer import (
        init_generator_train_state,
        make_generator_train_step_from_tokens,
    )
    from maskbit_tpu_torch.train.optim import make_optimizer

    model = _flagship()
    depth, b = 2, 8
    # hidden dropout off (its masks come from each device's own generator);
    # attention dropout 0.1 through the kernels, with injected seeds
    mlm = dict(model["mlm_model"], depth=depth, dropout=0.0, attention_dropout=RATE)
    vq = model["vq_model"]
    rng = np.random.default_rng(0)
    seq = (256 // 16) ** 2
    tokens = rng.integers(0, vq["codebook_size"], size=(b, seq)).astype(np.int64)
    labels = rng.integers(0, 1000, size=(b,)).astype(np.int64)
    injected = {"mask_ratio_uniform": rng.random(b, dtype=np.float32),
                "mask_token_uniform": rng.random((b, seq, mlm["codebook_splits"]), dtype=np.float32),
                "label_drop_uniform": rng.random(b, dtype=np.float32),
                "attention_seeds": [rng.integers(0, 2**32, size=(b, mlm["heads"]), dtype=np.int64)
                                    for _ in range(depth)]}

    cpu = build_module(lambda: LFQBert.from_config(mlm, vq), "cpu")
    init_generator_weights_(cpu, torch.Generator().manual_seed(1))
    card = build_module(lambda: LFQBert.from_config(mlm, vq, dtype=torch.bfloat16), "cuda")
    card.load_state_dict(cpu.state_dict(), strict=True)
    results = {}
    before = dict(da.launches)
    for name, gen, dev in (("card", card, "cuda"), ("cpu", cpu, "cpu")):
        opt = make_optimizer(gen.parameters(), lambda t: 1e-4, beta2=0.96, weight_decay=0.045)
        train_step = make_generator_train_step_from_tokens(
            gen, vq["codebook_size"], MLMLossConfig(), class_label_dropout=0.1,
            ema_kwargs={"decay": 0.9999})
        _, metrics = train_step(init_generator_train_state(gen, opt),
                                torch.from_numpy(tokens).to(dev), torch.from_numpy(labels).to(dev),
                                injected=injected)
        results[name] = {k: float(metrics[k]) for k in ("mlm_loss", "grad_norm")}
    launched = {k: da.launches[k] - before[k] for k in before}
    rel = {k: abs(results["card"][k] - results["cpu"][k]) / abs(results["cpu"][k])
           for k in ("mlm_loss", "grad_norm")}
    log(f"[train-check] flagship width, depth {depth}, batch {b}: loss card(bf16 kernels) "
        f"{results['card']['mlm_loss']:.6f} vs cpu(f32 plain) {results['cpu']['mlm_loss']:.6f} "
        f"(rel {rel['mlm_loss']:.2e}, tol 1e-2); grad norm {results['card']['grad_norm']:.6f} vs "
        f"{results['cpu']['grad_norm']:.6f} (rel {rel['grad_norm']:.2e}, tol 5e-2); "
        f"kernel launches {launched}")
    # bf16 keeps 8 significant bits: a few roundings per layer keep the loss
    # within ~1e-3 and the grad norm (a sum of squares over every parameter)
    # within a few 1e-3 of the f32 step; the tolerances leave room.
    if (launched["dropout_attention_fwd"] != depth or launched["dropout_attention_bwd"] != depth
            or rel["mlm_loss"] > 1e-2 or rel["grad_norm"] > 5e-2):
        raise AssertionError(f"train step disagrees: {results}, launches {launched}")
    return {"results": results, "rel": rel}


def phase_train_slice(torch, device_info) -> dict:
    """The training CLI at full width and depth."""
    from maskbit_tpu_torch.cli.common import build_module
    from maskbit_tpu_torch.cli.train_maskbit import main
    from maskbit_tpu_torch.core.checkpoint import load_pretrained
    from maskbit_tpu_torch.models.generator import LFQBert
    from maskbit_tpu_torch.nn import attention_block as ab
    from maskbit_tpu_torch.nn import dropout_attention as da

    model = _flagship()
    depth = int(model["mlm_model"]["depth"])
    out_dir = os.path.join(ROOT, "build", "chip_smoke_train")  # git-ignored; weights are ~1 GB
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = [f"config={CONFIG}", f"training.per_device_batch_size={TRAIN_BATCH}",
            f"training.max_train_steps={TRAIN_STEPS}", "training.device=cuda",
            "experiment.vqgan_checkpoint=", "experiment.log_every=1",
            f"experiment.output_dir={out_dir}"]
    for key in da.launches:
        da.launches[key] = 0
    ab.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = main(argv)
    wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launched = dict(da.launches)
    hist = result["history"]
    losses = [h["mlm_loss"] for h in hist]
    step_s = [h["perf/step_seconds"] for h in hist]
    data_s = [h["perf/data_seconds"] for h in hist]
    median_s = statistics.median(step_s[1:])
    median_data_s = statistics.median(data_s[1:])
    log(f"[train] {len(hist)} steps at batch {TRAIN_BATCH}, depth {depth}: losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; step seconds "
        f"{', '.join(f'{x:.4f}' for x in step_s)}")
    log(f"[train] median step (steps 2..{len(hist)}) {median_s * 1e3:.1f} ms = "
        f"{TRAIN_BATCH / median_s:.1f} samples/s, of which {median_data_s * 1e3:.1f} ms making "
        f"the synthetic batch on the host; peak memory {peak_gib:.2f} GiB; wall "
        f"{wall:.1f} s [{device_info['card']}]")
    log(f"[train] launches {launched} (expected depth {depth} x steps {TRAIN_STEPS} = "
        f"{depth * TRAIN_STEPS} of each dropout kernel); attention_block {ab.launches}")
    if len(losses) != TRAIN_STEPS or not all(x == x and abs(x) < float("inf") for x in losses):
        raise AssertionError(f"non-finite or missing losses: {losses}")
    for key in ("dropout_attention_fwd", "dropout_attention_bwd"):
        if launched[key] != depth * TRAIN_STEPS:
            raise AssertionError(f"{key} launched {launched[key]} times, expected "
                                 f"{depth * TRAIN_STEPS}")
    mlm, vq = model["mlm_model"], model["vq_model"]
    for name in (f"model-{TRAIN_STEPS}.bin", f"ema_model-{TRAIN_STEPS}.bin"):
        gen = build_module(lambda: LFQBert.from_config(mlm, vq), "cpu")
        gen.load_state_dict(load_pretrained(os.path.join(out_dir, name)), strict=True)
        if not all(bool(torch.isfinite(p).all()) for p in gen.parameters()):
            raise AssertionError(f"{name} holds non-finite weights")
    log(f"[train] model-{TRAIN_STEPS}.bin and ema_model-{TRAIN_STEPS}.bin load strictly")
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"launches": launched, "losses": losses, "step_seconds": step_s,
            "data_seconds": data_s, "median_step_s": median_s, "median_data_s": median_data_s,
            "samples_per_s": TRAIN_BATCH / median_s, "peak_gib": peak_gib}


def _state_copy(state) -> dict:
    """Every tensor and count of a train state, copied to the host."""
    from maskbit_tpu_torch.core.checkpoint import host_copy

    return host_copy(state.state_dict())


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if hasattr(tree, "dtype") else []


def _differences(a, b, path="") -> list:
    """Where two host copies of a train state differ (bit for bit)."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return [f"{path}: keys differ"]
        return [d for k in a for d in _differences(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [f"{path}: lengths differ"]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in _differences(x, y, f"{path}/{i}")]
    if hasattr(a, "dtype"):
        same = a.shape == b.shape and a.dtype == b.dtype and bool((a == b).all())
        return [] if same else [path]
    return [] if a == b else [f"{path}: {a} != {b}"]


def phase_train_data(torch, device_info, image_train, device="cuda") -> dict:
    """Pretokenize, train from token shards with saves and in-training
    generation, resume, and remat at 512 px (phase 7). `image_train` is
    phase 6's result, for the comparison. device="cpu" rehearses the phase
    with tiny configs put in place of CONFIG and CONFIG_512 (launches and
    memory are then neither counted nor checked)."""
    import logging

    import numpy as np

    from maskbit_tpu_torch.cli import train_maskbit
    from maskbit_tpu_torch.cli.common import build_tokenizer, compute_dtype
    from maskbit_tpu_torch.cli.pretokenize import tokenize_to_shards
    from maskbit_tpu_torch.core.checkpoint import CheckpointManager
    from maskbit_tpu_torch.core.config import load_config
    from maskbit_tpu_torch.data.token_shards import TokenShardWriter
    from maskbit_tpu_torch.nn import attention_block as ab
    from maskbit_tpu_torch.nn import dropout_attention as da

    work = os.path.join(ROOT, "build", "chip_smoke_data")  # git-ignored; checkpoints are ~5 GB
    shutil.rmtree(work, ignore_errors=True)
    config = load_config(CONFIG)
    mlm = config.model.mlm_model
    depth, sampling_steps = int(mlm["depth"]), int(mlm["num_steps"])
    res = int(config.select("dataset.preprocessing.resolution"))
    seq = (res // int(mlm.get("input_stride", 16))) ** 2

    # a. pretokenize synthetic images on the card
    tokenizer = build_tokenizer(config, train_maskbit._logger(), torch.device(device),
                                compute_dtype(config, default="no"))
    rng = np.random.default_rng(0)

    def images(n):
        for _ in range(n // TRAIN_BATCH):
            yield {"image": rng.uniform(size=(TRAIN_BATCH, res, res, 3)).astype(np.float32),
                   "class_id": rng.integers(0, 1000, TRAIN_BATCH).astype(np.int32)}

    tokenize_to_shards(tokenizer, images(TRAIN_BATCH),  # warm-up (cuDNN plans), thrown away
                       TokenShardWriter(os.path.join(work, "warmup-%04d.npz")), device)
    pattern = os.path.join(work, "tokens", "train-%04d.npz")
    t0 = time.perf_counter()
    n_images = tokenize_to_shards(tokenizer, images(PRETOKENIZE_IMAGES),
                                  TokenShardWriter(pattern, maxcount=128), device)
    pretok_s = time.perf_counter() - t0
    del tokenizer
    tokens_per_s = n_images * seq / pretok_s
    log(f"[train-data] pretokenize {n_images} synthetic {res} px images at batch {TRAIN_BATCH} "
        f"in {pretok_s:.3f} s = {n_images / pretok_s:.1f} images/s = {tokens_per_s:.0f} tokens/s "
        f"(host batch, copy, tokenize, fetch, .npz write) [{device_info['card']}]")

    # b. train from the token shards, saving and generating every 3 steps
    out_dir = os.path.join(work, "train")
    argv = [f"config={CONFIG}", f"training.per_device_batch_size={TRAIN_BATCH}",
            f"training.max_train_steps={TRAIN_STEPS}", f"training.device={device}",
            "experiment.vqgan_checkpoint=", "experiment.log_every=1",
            f"experiment.save_every={SAVE_EVERY}", f"experiment.generate_every={SAVE_EVERY}",
            f"experiment.output_dir={out_dir}",
            f"dataset.params.token_shards_path_or_url={os.path.join(work, 'tokens', 'train-*.npz')}"]
    copies = {}
    real_save, real_restore = CheckpointManager.save, CheckpointManager.restore_latest

    def save(self, step, state, *args, **kwargs):  # a host copy taken before the save
        if step == TRAIN_STEPS:
            copies["saved"] = _state_copy(state)
        return real_save(self, step, state, *args, **kwargs)

    def restore_latest(self, state):  # and one of what the restore gave back
        restored = real_restore(self, state)
        if restored is not None:
            if device == "cuda":
                torch.cuda.synchronize()
            copies["restored"] = _state_copy(state)
        return restored

    messages = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    train_logger = train_maskbit._logger()
    train_logger.addHandler(handler)
    CheckpointManager.save, CheckpointManager.restore_latest = save, restore_latest
    try:
        for key in da.launches:
            da.launches[key] = 0
        ab.launches = 0
        t0 = time.perf_counter()
        first = train_maskbit.main(argv)
        first_wall = time.perf_counter() - t0
        launched = dict(da.launches, attention_block=ab.launches)

        for key in da.launches:
            da.launches[key] = 0
        ab.launches = 0
        t0 = time.perf_counter()
        second = train_maskbit.main(argv + [f"training.max_train_steps={RESUME_STEPS}"])
        second_wall = time.perf_counter() - t0
        resume_launched = dict(da.launches, attention_block=ab.launches)
    finally:
        CheckpointManager.save, CheckpointManager.restore_latest = real_save, real_restore
        train_logger.removeHandler(handler)

    hist = first["history"]
    losses = [h["mlm_loss"] for h in hist]
    step_s = [h["perf/step_seconds"] for h in hist]
    data_s = [h["perf/data_seconds"] for h in hist]
    median_s = statistics.median(step_s[1:])
    n_gen = TRAIN_STEPS // SAVE_EVERY
    want = {"dropout_attention_fwd": depth * TRAIN_STEPS, "dropout_attention_bwd": depth * TRAIN_STEPS,
            "attention_block": depth * sampling_steps * n_gen,
            "fused_attention": depth * sampling_steps * n_gen}
    saves = [t for t in first["checkpoint_timings"] if "step" in t]
    images_dir = os.path.join(out_dir, "images")
    grids = sorted(os.listdir(images_dir)) if os.path.isdir(images_dir) else []
    log(f"[train-data] from token shards: {len(hist)} steps at batch {TRAIN_BATCH}, depth {depth}: "
        f"losses {', '.join(f'{x:.4f}' for x in losses)}; step seconds "
        f"{', '.join(f'{x:.4f}' for x in step_s)}; data seconds "
        f"{', '.join(f'{x:.4f}' for x in data_s)}")
    image_note = (f"; image input (phase 6, same call) {image_train['median_step_s'] * 1e3:.1f} ms = "
                  f"{image_train['samples_per_s']:.1f} samples/s" if image_train else "")
    log(f"[train-data] median step (steps 2..{len(hist)}) {median_s * 1e3:.1f} ms = "
        f"{TRAIN_BATCH / median_s:.1f} samples/s from tokens{image_note}; run wall "
        f"{first_wall:.1f} s [{device_info['card']}]")
    state_gb = sum(t.numel() * t.element_size() for t in _tensors(copies["saved"])) / 1e9
    log(f"[train-data] saves (train state {state_gb:.2f} GB: parameters, two moments, EMA): " + "; ".join(
        f"step {t['step']}: host copy {t['host_copy_s']:.3f} s, write (background) "
        f"{t['write_s']:.3f} s" for t in saves) + "; save calls in the loop (host copy + two "
        ".bin files) " + ", ".join(f"{x:.3f} s" for x in first["save_seconds"]))
    log(f"[train-data] launches {launched}, expected {want} "
        f"({n_gen} generations of {sampling_steps} sampling steps); grids {grids}")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite or missing losses: {losses}")
    if device == "cuda" and {k: launched[k] for k in want} != want:  # kernels run on the card only
        raise AssertionError(f"launches {launched} != {want}")
    want_grids = [f"train_{kind}-{s:09d}.png" for kind in ("decoded", "generated")
                  for s in range(SAVE_EVERY, TRAIN_STEPS + 1, SAVE_EVERY)]
    if grids != want_grids:
        raise AssertionError(f"generated grids {grids} != {want_grids}")

    # c. the resumed run
    restore_s = [t["restore_s"] for t in second["checkpoint_timings"] if "restore_s" in t]
    mismatched = _differences(copies["saved"], copies["restored"])
    resumed_losses = [h["mlm_loss"] for h in second["history"]]
    log(f"[train-data] resume: {[m for m in messages if m.startswith('resumed')]}; restore "
        f"{restore_s[0]:.3f} s (torch.load mmap + copy to the card); restored state vs the host "
        f"copy taken before the step-{TRAIN_STEPS} save: {len(mismatched)} tensors or counts "
        f"differ; steps {[h['step'] for h in second['history']]} losses "
        f"{', '.join(f'{x:.4f}' for x in resumed_losses)}; launches {resume_launched}; run wall "
        f"{second_wall:.1f} s")
    if f"resumed from step {TRAIN_STEPS}" not in messages or second["resumed_from"] != TRAIN_STEPS:
        raise AssertionError(f"the second run did not resume from step {TRAIN_STEPS}")
    if mismatched:
        raise AssertionError(f"restored state differs from the saved one at {mismatched[:5]}")
    if ([h["step"] for h in second["history"]] != list(range(TRAIN_STEPS + 1, RESUME_STEPS + 1))
            or not all(np.isfinite(resumed_losses))):
        raise AssertionError(f"resumed steps wrong or non-finite: {second['history']}")
    del copies
    shutil.rmtree(work, ignore_errors=True)

    remat = phase_remat(torch, device_info, device)
    return {"pretokenize": {"images": n_images, "seconds": pretok_s, "tokens_per_s": tokens_per_s},
            "launches": launched, "resume_launches": resume_launched, "losses": losses,
            "step_seconds": step_s, "data_seconds": data_s, "median_step_s": median_s,
            "samples_per_s": TRAIN_BATCH / median_s, "saves": saves,
            "save_seconds": first["save_seconds"], "restore_s": restore_s[0],
            "resumed_losses": resumed_losses, "remat": remat}


def phase_remat(torch, device_info, device="cuda") -> dict:
    """One step of the 512 px config at its batch 8 with remat off and on,
    from the same weights, tokens and generator seed."""
    import numpy as np

    from maskbit_tpu_torch.cli.common import build_module, compute_dtype
    from maskbit_tpu_torch.core.config import load_config
    from maskbit_tpu_torch.losses.mlm import MLMLossConfig
    from maskbit_tpu_torch.models.generator import LFQBert, init_generator_weights_
    from maskbit_tpu_torch.nn import dropout_attention as da
    from maskbit_tpu_torch.train.generator_trainer import (
        init_generator_train_state,
        make_generator_train_step_from_tokens,
    )
    from maskbit_tpu_torch.train.optim import make_optimizer

    config = load_config(CONFIG_512)
    vq = config.model.vq_model
    dtype = compute_dtype(config, default="no")
    batch = int(config.select("training.per_device_batch_size"))
    on_card = device == "cuda"
    runs = {}
    for remat in (False, True):
        mlm = dict(config.model.mlm_model.to_dict(), remat=remat)
        model = build_module(lambda: LFQBert.from_config(mlm, vq, dtype=dtype), device)
        init_generator_weights_(model, torch.Generator(device=device).manual_seed(1))
        opt = make_optimizer(model.parameters(), lambda t: 1e-4, beta2=0.96, weight_decay=0.045)
        state = init_generator_train_state(model, opt)
        step = make_generator_train_step_from_tokens(
            model, vq["codebook_size"], MLMLossConfig.from_config(config.select("losses.mlm", {})),
            ema_kwargs={"decay": 0.9999}, log_param_grad_norms=True)
        g = torch.Generator(device=device).manual_seed(2)
        tokens = torch.randint(0, vq["codebook_size"], (batch, model.seq_len), generator=g,
                               device=device)
        labels = torch.randint(0, 1000, (batch,), generator=g, device=device)
        gen = torch.Generator(device=device).manual_seed(3)
        before = dict(da.launches)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            static = torch.cuda.memory_allocated()
        state, metrics = step(state, tokens, labels, gen)
        metrics = {k: v.float().cpu() for k, v in metrics.items() if not k.startswith("_")}
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        launched = {k: da.launches[k] - before[k] for k in before}
        params = {n: p.detach().cpu() for n, p in model.named_parameters()}
        step_ms = _device_ms(torch, lambda: step(state, tokens, labels, gen), iters=3,
                             warmup=1) if on_card else 0.0
        runs[remat] = dict(metrics=metrics, params=params, launched=launched,
                           peak_gib=peak / 2**30, static_gib=static / 2**30 if on_card else 0.0,
                           step_ms=step_ms)
        del model, opt, state, step
        if on_card:
            torch.cuda.empty_cache()
    off, on = runs[False], runs[True]
    loss_diff = abs(off["metrics"]["mlm_loss"].item() - on["metrics"]["mlm_loss"].item())
    metric_diffs = [k for k in off["metrics"] if not torch.equal(off["metrics"][k], on["metrics"][k])]
    param_diffs = [n for n in off["params"] if not torch.equal(off["params"][n], on["params"][n])]
    depth = int(config.model.mlm_model["depth"])
    for name, r in (("off", off), ("on", on)):
        log(f"[remat] {name}: 512 px, batch {batch}, depth {depth}: peak memory {r['peak_gib']:.2f} "
            f"GiB (parameters, moments, EMA and the rest before the step {r['static_gib']:.2f} GiB; "
            f"the step's own {r['peak_gib'] - r['static_gib']:.2f} GiB); step device time "
            f"{r['step_ms']:.1f} ms; dropout launches {r['launched']} [{device_info['card']}]")
    log(f"[remat] loss {off['metrics']['mlm_loss'].item():.6f} vs {on['metrics']['mlm_loss'].item():.6f} "
        f"(|diff| {loss_diff:.3e}); metrics that differ {len(metric_diffs)} of "
        f"{len(off['metrics'])} (loss, grad norms per parameter); updated parameters that differ "
        f"{len(param_diffs)} of {len(off['params'])} (bit for bit expected)")
    if metric_diffs or param_diffs:
        raise AssertionError(f"remat changes the step: {metric_diffs[:5]} {param_diffs[:5]}")
    if device == "cuda" and (off["launched"]["dropout_attention_fwd"] != depth
            or on["launched"]["dropout_attention_fwd"] != 2 * depth
            or on["launched"]["dropout_attention_bwd"] != depth):
        raise AssertionError(f"remat launches {off['launched']} / {on['launched']}")
    return {name: {k: r[k] for k in ("peak_gib", "static_gib", "step_ms", "launched")}
            for name, r in (("off", off), ("on", on))}


def _tf1_resize_numpy(x, out_h, out_w):
    """Numpy replica of the TF1 legacy bilinear resize (NHWC float32):
    src = dst * (in/out), floor and floor + 1 clamped, a + (b - a) * t,
    the width axis first."""
    import numpy as np

    def grid(in_size, out_size):
        scale = np.float32(in_size / out_size)
        src = np.arange(out_size, dtype=np.float32) * scale
        lo = np.minimum(np.floor(src), in_size - 1).astype(np.int64)
        hi = np.minimum(lo + 1, in_size - 1)
        return lo, hi, (src - lo.astype(np.float32)).astype(np.float32)

    lo_x, hi_x, t_x = grid(x.shape[2], out_w)
    lo_y, hi_y, t_y = grid(x.shape[1], out_h)
    left, right = x[:, :, lo_x], x[:, :, hi_x]
    x = left + (right - left) * t_x[None, None, :, None]
    top, bottom = x[:, lo_y], x[:, hi_y]
    return top + (bottom - top) * t_y[None, :, None, None]


def _write_image_shards(pattern: str, n: int, res: int) -> None:
    """n synthetic res x res JPEGs (smooth random colour fields, seeded) as
    tar shards of 128 through the port's `ShardWriter`."""
    import numpy as np
    from PIL import Image

    from maskbit_tpu_torch.data.shard_writer import ShardWriter

    rng = np.random.default_rng(0)
    writer = ShardWriter(pattern, maxcount=128)
    for i in range(n):
        low = rng.uniform(0, 255, (8, 8, 3)).astype(np.uint8)
        img = Image.fromarray(low).resize((res, res), Image.BILINEAR)
        buf = io.BytesIO()
        img.save(buf, "JPEG", quality=90)
        writer.write(f"{i:06d}", buf.getvalue(), i % 1000)
    writer.close()


def phase_eval(torch, device_info, device="cuda") -> dict:
    """Evaluation on the card (phase 8): Inception, make_stats,
    eval_maskbit at batch 100 through the attention block, eval_tokenizer
    for an LFQ and a VQ tokenizer. device="cpu" rehearses the phase with
    tiny configs put in place of CONFIG and TOKENIZER_CONFIGS (launches are
    then not checked, and the TF32 comparison is skipped)."""
    import contextlib

    import numpy as np

    from maskbit_tpu_torch.cli import eval_maskbit, eval_tokenizer, make_stats
    from maskbit_tpu_torch.core.config import load_config
    from maskbit_tpu_torch.eval import inception as inc
    from maskbit_tpu_torch.nn import attention_block as ab
    from maskbit_tpu_torch.nn import dropout_attention as da

    work = os.path.join(ROOT, "build", "chip_smoke_data")  # git-ignored
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    weights = os.path.join(work, "pt_inception.pth")
    torch.save(inc.random_inception_state(0), weights)
    env = {"MASKBIT_INCEPTION_WEIGHTS": weights, "MASKBIT_ADM_PB": ""}
    saved_env = {k: os.environ.get(k) for k in (*env, "MASKBIT_EVAL_MAX_BATCHES")}
    os.environ.update(env)
    try:
        # a. the resize bit for bit, the features on the card against the CPU's
        rng = np.random.default_rng(0)
        x = rng.uniform(0, 255, (8, 256, 256, 3)).astype(np.float32)
        resized = inc.resize_bilinear_tf1(torch.from_numpy(x).to(device), 299, 299).cpu().numpy()
        resize_flips = int((resized != _tf1_resize_numpy(x, 299, 299)).sum())
        images = torch.from_numpy(rng.integers(0, 256, (8, 256, 256, 3), dtype=np.uint8))
        state = inc.load_inception_params(weights)
        card_fn, cpu_fn = (inc.inception_from_state(state, d) for d in (device, "cpu"))
        with torch.inference_mode():
            cpu = cpu_fn(images)["2048"]
            card = card_fn(images.to(device))["2048"].cpu()
            tf32 = card
            if device == "cuda":  # for information: the same call with TF32 allowed
                real_full_f32 = inc.full_f32
                inc.full_f32 = contextlib.nullcontext
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
                try:
                    tf32 = card_fn(images.cuda())["2048"].cpu()
                finally:
                    inc.full_f32 = real_full_f32
                    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        scale = cpu.abs().max().item()
        gap, tf32_gap = ((t - cpu).abs().max().item() / scale for t in (card, tf32))
        log(f"[eval] resize_bilinear_tf1 256->299 on the card vs numpy: {resize_flips} of "
            f"{resized.size} values differ; Inception '2048' of 8 images, card f32 vs cpu f32: "
            f"max |diff| / max|cpu| {gap:.3e} (max|cpu| {scale:.4f}); with TF32 allowed "
            f"{tf32_gap:.3e}")
        if resize_flips or not torch.isfinite(card).all() or gap > 1e-3:
            raise AssertionError(f"Inception on the card: resize flips {resize_flips}, "
                                 f"feature gap {gap}")
        del card_fn, cpu_fn

        # b. stats of 512 synthetic images
        res = int(load_config(CONFIG).select("dataset.preprocessing.resolution"))
        pattern = os.path.join(work, "shards", "img-%04d.tar")
        os.makedirs(os.path.dirname(pattern))
        _write_image_shards(pattern, STATS_IMAGES, res)
        shards = os.path.join(work, "shards", f"img-{{0000..{(STATS_IMAGES - 1) // 128:04d}}}.tar")
        stats = os.path.join(work, "stats.npz")
        t0 = time.perf_counter()
        n_stats = make_stats.main(["--shards", shards, "--output", stats, "--resolution", str(res),
                                   "--batch_size", "128", "--device", device])
        stats_s = time.perf_counter() - t0
        log(f"[eval] make_stats: {n_stats} images in {stats_s:.2f} s (tar read, JPEG decode, "
            f"Inception f32, float64 moments)")

        # c. eval_maskbit at batch 100
        mlm = _flagship()["mlm_model"]
        depth, steps = int(mlm["depth"]), int(mlm["num_steps"])
        argv = [f"config={CONFIG}", f"eval.total_samples={EVAL_SAMPLES}",
                f"eval.batch_size={EVAL_BATCH}", f"eval.stats_path={stats}",
                f"eval.device={device}",
                "experiment.vqgan_checkpoint=", "experiment.generator_checkpoint=",
                f"experiment.output_dir={os.path.join(work, 'eval_maskbit')}"]
        for key in da.launches:
            da.launches[key] = 0
        ab.launches = 0
        t0 = time.perf_counter()
        gen = eval_maskbit.main(argv)
        wall = time.perf_counter() - t0
        launches = {"attention_block": ab.launches,
                    "fused_attention": da.launches["fused_attention"]}
        batches = -(-EVAL_SAMPLES // EVAL_BATCH)
        want = depth * steps * batches
        per = {k: [b[k] * 1e3 for b in gen["batch_seconds"]]
               for k in ("sampler", "inception", "moments")}
        sampling_s = sum(per["sampler"]) / 1e3
        results = gen["results"]
        log(f"[eval] eval_maskbit: {gen['count']} samples in {batches} batches of {EVAL_BATCH} "
            f"(CFG batch {2 * EVAL_BATCH} x 257), FID {results.get('FID')}, IS "
            f"{results.get('InceptionScore')}; wall {wall:.1f} s = "
            f"{EVAL_SAMPLES / wall:.3f} img/s, "
            f"sampling alone {EVAL_SAMPLES / sampling_s:.3f} img/s [{device_info['card']}]")
        for k, v in per.items():
            log(f"[eval]   per batch {k} ms: " + ", ".join(f"{x:.1f}" for x in v))
        log(f"[eval]   launches {launches}, expected depth {depth} x steps {steps} x batches "
            f"{batches} = {want} of each")
        if gen["count"] != EVAL_SAMPLES or (device == "cuda" and any(
                v != want for v in launches.values())):
            raise AssertionError(f"eval_maskbit scored {gen['count']}, launches {launches}")
        if set(results) != {"FID", "InceptionScore"} or not all(
                np.isfinite(v) for v in results.values()):
            raise AssertionError(f"eval_maskbit results {results}")

        # d. eval_tokenizer, LFQ and VQ
        os.environ["MASKBIT_EVAL_MAX_BATCHES"] = str(EVAL_TOKENIZER_BATCHES)
        tokenizers = {}
        for path in TOKENIZER_CONFIGS:
            name = os.path.basename(path)
            t0 = time.perf_counter()
            metrics = eval_tokenizer.main([
                f"config={path}", f"eval.device={device}",
                "experiment.vqgan_checkpoint=", f"dataset.params.train_shards_path_or_url={shards}",
                f"dataset.params.eval_shards_path_or_url={shards}",
                f"experiment.output_dir={os.path.join(work, 'eval_tokenizer', name)}"])
            tokenizers[name] = dict(metrics, seconds=time.perf_counter() - t0)
            log(f"[eval] eval_tokenizer {name}: {metrics} in {tokenizers[name]['seconds']:.1f} s")
            if len(metrics) != 8 or not all(np.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"eval_tokenizer {name}: {metrics}")
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(work, ignore_errors=True)
    return {"resize_flips": resize_flips, "inception_gap": gap, "inception_tf32_gap": tf32_gap,
            "stats_images": n_stats, "stats_s": stats_s, "launches": launches,
            "count": gen["count"], "results": results, "wall_s": wall,
            "img_per_s": EVAL_SAMPLES / wall, "batch_ms": per, "tokenizers": tokenizers}


def _entropy_check(torch, device) -> dict:
    """The streamed LFQ entropy at the 14-bit flagship's shape (batch 16,
    16x16 latents, 4096 codes a chunk) on the card with the global TF32
    flags on, against the CPU: terms and gradient. For information, the
    same with the entropy's own `full_f32` scope taken away."""
    import contextlib

    import numpy as np

    from maskbit_tpu_torch.ops import entropy

    z = (np.random.default_rng(0).normal(size=(16, 16, 16, 14)) * 0.05).astype(np.float32)

    def run(dev):
        zt = torch.from_numpy(z).to(dev).requires_grad_()
        terms = entropy.lfq_entropy_terms(zt, 14, 0.01, 1.0, 4096)
        (terms[0] - terms[1]).backward()
        return [float(t.detach()) for t in terms], zt.grad.cpu()

    want, want_grad = run("cpu")
    got, got_grad = run(device)
    real_full_f32 = entropy.full_f32
    entropy.full_f32 = contextlib.nullcontext  # for information: TF32 products
    try:
        tf32, tf32_grad = run(device)
    finally:
        entropy.full_f32 = real_full_f32
    scale = want_grad.abs().max().item()
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    grad_gap = (got_grad - want_grad).abs().max().item() / scale
    tf32_rel = max(abs(g - w) / abs(w) for g, w in zip(tf32, want))
    tf32_grad_gap = (tf32_grad - want_grad).abs().max().item() / scale
    log(f"[tokenizer-train] entropy at (16, 16, 16, 14), T 0.01, global TF32 on: card vs cpu "
        f"terms rel {rel:.2e} (tol 1e-4), gradient {grad_gap:.2e} of its max (tol 1e-3); "
        f"without the entropy's own full-f32 scope: terms rel {tf32_rel:.2e}, gradient "
        f"{tf32_grad_gap:.2e}")
    if rel > 1e-4 or grad_gap > 1e-3:
        raise AssertionError(f"entropy on the card: terms {got} vs {want}, gradient gap {grad_gap}")
    return {"rel": rel, "grad_gap": grad_gap, "tf32_rel": tf32_rel, "tf32_grad_gap": tf32_grad_gap}


TINY_STAGE1 = {
    "vq_model": {"quantizer_type": "lookup-free", "codebook_size": 1024, "token_size": 10,
                 "entropy_loss_weight": 0.02, "entropy_loss_temperature": 0.01,
                 "hidden_channels": 64, "channel_mult": [1, 2], "num_resolutions": 2,
                 "num_res_blocks": 1},
    "discriminator": {"name": "VQGAN+Discriminator", "num_stages": 1, "hidden_channels": 64,
                      "blur_resample": True, "blur_kernel_size": 4},
    "losses": {"perceptual_loss": "none", "perceptual_weight": 0.0, "reconstruction_weight": 4.0,
               "discriminator_start": 0, "discriminator_weight": 0.02,
               "discriminator_gradient_penalty": "adopt_weight",
               "lecam_regularization_weight": 0.001, "entropy_annealing_steps": 2000,
               "entropy_annealing_factor": 2.0},
}


def _tiny_step_check(torch, device) -> dict:
    """One float32 Stage-I step (64 px, the discriminator and adaptive weight
    live, the 10-bit entropy at T 0.01) on the card with TF32 allowed for
    matrix products (the flag that reaches the entropy's affinities; cuDNN's
    convolutions stay in float32, so that the comparison is tight), against
    the same step on the CPU from the same weights; for information, the
    card's step again with the entropy's own full-f32 scope taken away."""
    import contextlib

    import numpy as np

    from maskbit_tpu_torch.cli.common import build_module
    from maskbit_tpu_torch.losses.vqgan import VQGANLossConfig
    from maskbit_tpu_torch.models.tokenizer import ConvVQModel, init_tokenizer_weights_
    from maskbit_tpu_torch.nn.discriminator import create_discriminator, init_discriminator_weights_
    from maskbit_tpu_torch.ops import entropy
    from maskbit_tpu_torch.train.optim import make_optimizer
    from maskbit_tpu_torch.train.tokenizer_trainer import (
        init_tokenizer_train_state,
        make_tokenizer_train_step,
    )

    cfg = TINY_STAGE1
    images = torch.from_numpy(
        np.random.default_rng(1).uniform(size=(4, 64, 64, 3)).astype(np.float32))
    weights = {}

    def run(dev):
        model = build_module(lambda: ConvVQModel.from_config(cfg["vq_model"]), dev)
        disc = build_module(lambda: create_discriminator(cfg["discriminator"]), dev)
        if not weights:
            init_tokenizer_weights_(model, torch.Generator().manual_seed(0))
            init_discriminator_weights_(disc, torch.Generator().manual_seed(1))
            weights.update(model={k: v.clone() for k, v in model.state_dict().items()},
                           disc={k: v.clone() for k, v in disc.state_dict().items()})
        model.load_state_dict(weights["model"], strict=True)
        disc.load_state_dict(weights["disc"], strict=True)
        state = init_tokenizer_train_state(model, disc,
                                           make_optimizer(model.parameters(), lambda t: 1e-4),
                                           make_optimizer(disc.parameters(), lambda t: 1e-4))
        step = make_tokenizer_train_step(model, disc, VQGANLossConfig.from_config(cfg["losses"]),
                                         ema_kwargs={"decay": 0.999})
        return {k: float(v) for k, v in step(state, images.to(dev))[1].items()}

    keys = ("total_loss", "reconstruction_loss", "quantizer_loss", "commitment_loss",
            "entropy_loss", "per_sample_entropy", "gan_loss", "d_weight", "discriminator_loss",
            "grad_norm")

    def rel(got, want):
        return {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-6) for k in keys}

    cpu = run("cpu")
    card = run(device)
    real_full_f32 = entropy.full_f32
    entropy.full_f32 = contextlib.nullcontext  # for information: TF32 affinities
    try:
        tf32 = rel(run(device), cpu)
    finally:
        entropy.full_f32 = real_full_f32
    gaps = rel(card, cpu)
    log("[tokenizer-train] one float32 step (64 px, 10-bit LFQ, T 0.01, D live), TF32 allowed "
        "for matrix products, card vs cpu: " + ", ".join(
            f"{k} {card[k]:.6f} vs {cpu[k]:.6f}" for k in keys)
        + f"; max rel {max(gaps.values()):.2e} (tol 1e-3); without the entropy's full-f32 "
        f"scope: " + ", ".join(f"{k} {v:.1e}" for k, v in tf32.items() if v > 1e-4))
    if max(gaps.values()) > 1e-3:
        raise AssertionError(f"the Stage-I step on the card disagrees: {gaps}")
    return {"card": card, "cpu": cpu, "rel": gaps, "rel_without_full_f32": tf32}


def _random_resnet50(torch, path: str) -> None:
    """Seeded random torchvision-layout resnet50 weights (flax's default
    initialisation) saved as a `.pth`."""
    from maskbit_tpu_torch.losses.perceptual import ResNet50
    from maskbit_tpu_torch.nn.conv import init_flax_defaults_

    model = ResNet50()
    init_flax_defaults_(model, torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), path)


_STEP_CATEGORIES = (
    ("multi_tensor_apply", "optimizer, EMA, grad norm (foreach)"),
    ("nchwToNhwc", "layout transposes (cuDNN)"), ("nhwcToNchw", "layout transposes (cuDNN)"),
    ("conv_depthwise2d", "the blur (depthwise convolution)"),
    ("conv2d_grouped_direct", "the blur (depthwise convolution)"),
    ("bn_fw", "norms"), ("group_norm", "norms"), ("GroupNorm", "norms"),
    ("batch_norm", "norms"), ("welford", "norms"), ("layer_norm", "norms"),
    ("RowwiseMoments", "norms"), ("ComputeInternalGradients", "norms"),
    ("xmma", "convolutions (cuDNN)"), ("implicit", "convolutions (cuDNN)"),
    ("grad2d", "convolutions (cuDNN)"), ("dgrad", "convolutions (cuDNN)"),
    ("wgrad", "convolutions (cuDNN)"), ("conv", "convolutions (cuDNN)"),
    ("cudnn", "convolutions (cuDNN)"),
    ("gemm", "GEMM"), ("nvjet", "GEMM"),
    ("upsample", "upsample, pooling"), ("pool", "upsample, pooling"),
)


def _step_category(name: str) -> str:
    for key, category in _STEP_CATEGORIES:
        if key in name:
            return category
    return "elementwise, reductions, casts, copies"


def _stage1_breakdown(torch, run, images) -> dict:
    """Device time of one Stage-I step (discriminator live) by kernel
    category under torch.profiler, and of its parts timed alone: the
    ResNet-50 perceptual loss (forward, and backward to its input), the
    streamed entropy (forward and backward), the optimizers' and EMA's
    foreach passes."""
    from collections import defaultdict

    from maskbit_tpu_torch.ops.entropy import lfq_entropy_terms

    state, step = run["state"], run["train_step"]
    by_cat = defaultdict(float)
    events = _device_breakdown(torch, lambda: step(state, images), iters=1, warmup=2)
    # the trainer's record_function ranges come back as device events too:
    # the phases' device spans, kept apart from the kernels
    phases = {k: v for k, v in events.items() if k.startswith("tokenizer/")}
    breakdown = {k: v for k, v in events.items() if k not in phases}
    for name, ms in breakdown.items():
        by_cat[_step_category(name)] += ms
    top = sorted(breakdown.items(), key=lambda kv: -kv[1])[:25]
    with open(os.path.join(OUT_DIR, "tokenizer_step_kernels.txt"), "w") as f:
        f.writelines(f"{ms:10.3f} ms  {_step_category(name):40s} {name}\n"
                     for name, ms in sorted(breakdown.items(), key=lambda kv: -kv[1]))
    parts = {}
    perceptual = run["perceptual"]
    if perceptual is not None:
        recon = images.flip(0).requires_grad_()
        parts["ResNet-50 perceptual, forward + backward to the input"] = _device_ms(
            torch, lambda: torch.autograd.grad(perceptual(images, recon), recon), iters=3)
    vq = run["model"].quantize
    z = torch.randn(images.shape[0], images.shape[1] // 16, images.shape[2] // 16,
                    vq.token_bits, device=images.device).mul_(0.05).requires_grad_()
    parts[f"entropy at {2 ** vq.token_bits} codes, forward + backward"] = _device_ms(
        torch, lambda: torch.autograd.grad(sum(lfq_entropy_terms(
            z, vq.token_bits, vq.entropy_loss_temperature, 1.0, vq.entropy_chunk_size)), z),
        iters=3)
    event_ms = _time_ms(torch, lambda: step(state, images), iters=3, warmup=0)
    return {"step_ms": sum(by_cat.values()), "event_ms": event_ms, "by_category": dict(by_cat),
            "phase_spans": phases, "parts": parts,
            "top_kernels": [(_kernel_name(k)[:120], ms) for k, ms in top]}


def phase_tokenizer_train(torch, device_info) -> dict:
    """Stage-I training on the card (phase 9): the entropy and one tiny
    step against the CPU with TF32 on; `cli/train_tokenizer.main` on the
    14-bit flagship at batch 16, 256 px, bf16 across the discriminator's
    gate with saves, reconstructions, an eval and a resume; the saved EMA
    weights through `cli/eval_tokenizer` with LPIPS; one step's device time
    by category; one step of the 18-bit config."""
    import logging

    import numpy as np

    from maskbit_tpu_torch.cli import eval_tokenizer, train_tokenizer
    from maskbit_tpu_torch.core.checkpoint import CheckpointManager
    from maskbit_tpu_torch.core.config import load_config
    from maskbit_tpu_torch.losses.lpips import random_vgg16_state

    config, device = TOKENIZER_CONFIGS[0], "cuda"
    work = os.path.join(ROOT, "build", "chip_smoke_data")  # git-ignored
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = {}
    # a. TF32 on: the entropy holds it off itself
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        out["entropy_check"] = _entropy_check(torch, device)
        torch.backends.cudnn.allow_tf32 = False
        out["step_check"] = _tiny_step_check(torch, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    resnet, vgg = os.path.join(work, "resnet50.pth"), os.path.join(work, "vgg16.pth")
    _random_resnet50(torch, resnet)
    torch.save(random_vgg16_state(0), vgg)
    env = {"MASKBIT_RESNET50_WEIGHTS": resnet, "MASKBIT_VGG16_WEIGHTS": vgg,
           "MASKBIT_INCEPTION_WEIGHTS": "", "MASKBIT_ADM_PB": "",
           "MASKBIT_EVAL_MAX_BATCHES": str(TOK_EVAL_BATCHES)}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out_dir = os.path.join(work, "tok_train")
    argv = [f"config={config}", f"training.device={device}",
            f"training.max_train_steps={TOK_STEPS}", f"losses.discriminator_start={TOK_GATE}",
            f"experiment.save_every={TOK_SAVE}", f"experiment.generate_every={TOK_SAVE}",
            f"experiment.eval_every={TOK_STEPS}", f"eval.max_eval_batches={TOK_EVAL_BATCHES}",
            "experiment.log_every=1", "experiment.logger=jsonl",
            f"experiment.output_dir={out_dir}"]
    copies = {}
    real_save, real_restore = CheckpointManager.save, CheckpointManager.restore_latest

    def save(self, step, state, *args, **kwargs):  # a host copy taken before the save
        if step == TOK_STEPS:
            copies["saved"] = _state_copy(state)
        return real_save(self, step, state, *args, **kwargs)

    def restore_latest(self, state):  # and one of what the restore gave back
        restored = real_restore(self, state)
        if restored is not None:
            torch.cuda.synchronize()
            copies["restored"] = _state_copy(state)
        return restored

    messages = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    train_logger = train_tokenizer._logger()
    train_logger.addHandler(handler)
    CheckpointManager.save, CheckpointManager.restore_latest = save, restore_latest
    torch.backends.cudnn.allow_tf32 = True  # b-d: PyTorch's defaults, as a user's run
    try:
        # b. the CLI across the gate, then a resume
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = train_tokenizer.main(argv)
        first_wall = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        t0 = time.perf_counter()
        second = train_tokenizer.main(argv + [f"training.max_train_steps={TOK_RESUME}"])
        second_wall = time.perf_counter() - t0
        # the saved EMA weights through eval_tokenizer, with LPIPS
        t0 = time.perf_counter()
        ema_path = os.path.join(out_dir, f"ema_model-{TOK_RESUME}.bin")
        scores = eval_tokenizer.main([f"config={config}", f"eval.device={device}",
                                      f"experiment.vqgan_checkpoint={ema_path}",
                                      f"experiment.output_dir={os.path.join(work, 'tok_eval')}"])
        eval_s = time.perf_counter() - t0

        # one step's device time by category, and the 18-bit step
        cfg = load_config(config)
        cfg.update_dotted("training.device", device)
        cfg.update_dotted("losses.discriminator_start", 0)
        cfg.update_dotted("experiment.output_dir", os.path.join(work, "profile"))
        batch = int(cfg.select("training.per_device_batch_size"))
        res = int(cfg.select("dataset.preprocessing.resolution"))
        images = torch.from_numpy(np.random.default_rng(2).uniform(
            size=(batch, res, res, 3)).astype(np.float32)).to(device)
        run = train_tokenizer.build_training(cfg, train_logger)
        breakdown = _stage1_breakdown(torch, run, images)
        del run
        out["step_18bit"] = _step_18bit(torch, images, train_logger, work)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        CheckpointManager.save, CheckpointManager.restore_latest = real_save, real_restore
        train_logger.removeHandler(handler)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    hist = first["history"]
    step_s = [h["perf/step_seconds"] for h in hist]
    before = statistics.median(step_s[1:TOK_GATE])
    after = statistics.median(step_s[TOK_GATE + 1:])
    perceptual = [h["perceptual_loss"] for h in hist]
    log(f"[tokenizer-train] {os.path.basename(config)}: {len(hist)} steps at batch {batch}, "
        f"discriminator from step {TOK_GATE}: total losses "
        f"{', '.join(f'{h["total_loss"]:.4f}' for h in hist)}; perceptual "
        f"{', '.join(f'{x:.3e}' for x in perceptual)}; discriminator "
        f"{', '.join(f'{h["discriminator_loss"]:.4f}' for h in hist)}; step seconds "
        f"{', '.join(f'{x:.4f}' for x in step_s)}")
    log(f"[tokenizer-train] median step before the gate (steps 2..{TOK_GATE}) "
        f"{before * 1e3:.1f} ms = {batch / before:.1f} samples/s; after it (steps "
        f"{TOK_GATE + 2}..{TOK_STEPS}) {after * 1e3:.1f} ms = {batch / after:.1f} samples/s; "
        f"peak memory {peak_gib:.2f} GiB; run wall {first_wall:.1f} s [{device_info['card']}]")
    saves = [t for t in first["checkpoint_timings"] if "step" in t]
    restore_s = [t["restore_s"] for t in second["checkpoint_timings"] if "restore_s" in t]
    mismatched = _differences(copies["saved"], copies["restored"])
    log(f"[tokenizer-train] saves held the loop " + ", ".join(
        f"{x:.3f} s" for x in first["save_seconds"]) + " (host copy " + ", ".join(
        f"{t['host_copy_s']:.3f}" for t in saves) + " s, then the two .bin files); restore "
        f"{restore_s[0]:.3f} s; restored state vs the host copy before the step-{TOK_STEPS} "
        f"save: {len(mismatched)} tensors or counts differ; resumed steps "
        f"{[h['step'] for h in second['history']]}; run wall {second_wall:.1f} s")
    log(f"[tokenizer-train] eval in the run at step {TOK_STEPS}: {first['evals']}; "
        f"eval_tokenizer on ema_model-{TOK_RESUME}.bin ({TOK_EVAL_BATCHES} batches, LPIPS "
        f"with the shipped lin heads and random VGG16): {scores} in {eval_s:.1f} s")
    log(f"[tokenizer-train] one step (discriminator live), device time "
        f"{breakdown['step_ms']:.2f} ms (CUDA events around a step, median of 3: "
        f"{breakdown['event_ms']:.2f} ms): " + ", ".join(
            f"{k} {v:.2f}" for k, v in sorted(breakdown["by_category"].items(),
                                               key=lambda kv: -kv[1]))
        + "; the trainer's ranges (device spans of the kernels launched in them): "
        + ", ".join(f"{k} {v:.2f}" for k, v in breakdown["phase_spans"].items())
        + "; alone: " + ", ".join(f"{k} {v:.2f} ms" for k, v in breakdown["parts"].items()))
    if len(hist) != TOK_STEPS or not all(np.isfinite([h["total_loss"] for h in hist])):
        raise AssertionError(f"missing or non-finite losses: {hist}")
    if not first["perceptual"] or any(x == 0.0 for x in perceptual):
        raise AssertionError(f"the perceptual loss is off or 0: {perceptual}")
    if any(h["discriminator_loss"] != 0.0 for h in hist[:TOK_GATE]) or any(
            h["discriminator_loss"] == 0.0 for h in hist[TOK_GATE:]):
        raise AssertionError("the discriminator's gate is not where it was set")
    if f"resumed from step {TOK_STEPS}" not in messages or second["resumed_from"] != TOK_STEPS:
        raise AssertionError(f"the second run did not resume from step {TOK_STEPS}")
    if mismatched:
        raise AssertionError(f"restored state differs from the saved one at {mismatched[:5]}")
    if [h["step"] for h in second["history"]] != list(range(TOK_STEPS + 1, TOK_RESUME + 1)):
        raise AssertionError(f"resumed steps wrong: {second['history']}")
    if not first["evals"] or "LPIPS" not in scores or not all(
            np.isfinite(v) for v in scores.values()):
        raise AssertionError(f"evals: {first['evals']}, eval_tokenizer {scores}")
    want_grids = [f"train_reconstructions-{s:09d}.png"
                  for s in range(TOK_SAVE, TOK_STEPS + 1, TOK_SAVE)]
    grids = sorted(os.listdir(os.path.join(out_dir, "images")))
    if grids[:len(want_grids)] != want_grids:
        raise AssertionError(f"reconstruction grids {grids} != {want_grids}")
    shutil.rmtree(work, ignore_errors=True)
    out.update({"losses": [h["total_loss"] for h in hist], "perceptual": perceptual,
                "step_seconds": step_s, "median_before_s": before, "median_after_s": after,
                "samples_per_s_before": batch / before, "samples_per_s_after": batch / after,
                "peak_gib": peak_gib, "save_seconds": first["save_seconds"], "saves": saves,
                "restore_s": restore_s[0], "eval_in_run": first["evals"], "eval_tokenizer": scores,
                "breakdown": breakdown, "wall_s": first_wall})
    return out


def _step_18bit(torch, images, logger, work) -> dict:
    """Two steps of the 18-bit config (262,144 codes; the discriminator
    live) on the same images: the second's time, the peak memory of a step,
    and the entropy's forward and backward alone."""
    import numpy as np

    from maskbit_tpu_torch.cli import train_tokenizer
    from maskbit_tpu_torch.core.config import load_config
    from maskbit_tpu_torch.ops.entropy import lfq_entropy_terms

    cfg = load_config(TOKENIZER_18)
    cfg.update_dotted("training.device", "cuda")
    cfg.update_dotted("losses.discriminator_start", 0)
    cfg.update_dotted("experiment.output_dir", os.path.join(work, "step18"))
    run = train_tokenizer.build_training(cfg, logger)
    state, step = run["state"], run["train_step"]
    _, metrics = step(state, images)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, metrics = step(state, images)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    vq = run["model"].quantize
    z = torch.randn(images.shape[0], images.shape[1] // 16, images.shape[2] // 16,
                    vq.token_bits, device="cuda").mul_(0.05).requires_grad_()
    entropy_fn = lambda: torch.autograd.grad(sum(lfq_entropy_terms(  # noqa: E731
        z, vq.token_bits, vq.entropy_loss_temperature, 1.0, vq.entropy_chunk_size)), z)
    entropy_ms = _device_ms(torch, entropy_fn, iters=3)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    entropy_fn()
    torch.cuda.synchronize()
    entropy_peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    log(f"[tokenizer-train] {os.path.basename(TOKENIZER_18)} ({2 ** vq.token_bits} codes, "
        f"{z.shape[0] * z.shape[1] * z.shape[2]} rows, chunks of {vq.entropy_chunk_size}): "
        f"a step {step_s * 1e3:.1f} ms, peak memory {peak_gib:.2f} GiB; the entropy's forward "
        f"and backward alone {entropy_ms:.2f} ms, its own peak {entropy_peak_mib:.1f} MiB; "
        f"total loss {float(metrics['total_loss']):.4f}, entropy loss "
        f"{float(metrics['entropy_loss']):.5f}")
    if not np.isfinite(float(metrics["total_loss"])):
        raise AssertionError(f"18-bit step: {metrics}")
    return {"step_s": step_s, "peak_gib": peak_gib, "entropy_ms": entropy_ms,
            "entropy_peak_mib": entropy_peak_mib, "total_loss": float(metrics["total_loss"])}


PHASES = ("kernels", "dropout", "generator", "slice", "train_check", "train", "train_data",
          "eval", "tokenizer_train")


def _args(argv):
    import argparse

    p = argparse.ArgumentParser(description="Smoke run of maskbit_tpu_torch on one CUDA card.")
    p.add_argument("--phases", default=",".join(PHASES),
                   help="comma-separated subset of %(default)s (device and build always run); "
                        "the JSON lines are printed only when all run")
    p.add_argument("--tree", default=ROOT,
                   help="checkout whose maskbit_tpu_torch to drive (default: this one), e.g. "
                        "a parent commit unpacked beside it, to compare two trees with one "
                        "script")
    args = p.parse_args(argv)
    args.phases = [x for x in args.phases.split(",") if x]
    unknown = set(args.phases) - set(PHASES)
    if unknown:
        p.error(f"unknown phases {sorted(unknown)}")
    return args


def main(argv=None) -> int:
    import torch

    args = _args(sys.argv[1:] if argv is None else argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import maskbit_tpu_torch  # noqa: F401 — fails when run outside the checkout

    if os.path.dirname(os.path.abspath(maskbit_tpu_torch.__file__)) != os.path.join(
            tree, "maskbit_tpu_torch"):
        raise RuntimeError(f"maskbit_tpu_torch did not load from {tree}")
    log(f"[tree] {tree}")
    device_info = phase_device(torch)
    phase_build()
    run = set(args.phases)
    kern = phase_kernels(torch) if "kernels" in run else None
    drop = phase_dropout_kernels(torch) if "dropout" in run else None
    if "generator" in run:
        phase_generator(torch)
    sl = phase_slice(torch, device_info) if "slice" in run else None
    check = phase_train_check(torch) if "train_check" in run else None
    tr = phase_train_slice(torch, device_info) if "train" in run else None
    data = phase_train_data(torch, device_info, tr) if "train_data" in run else None
    ev = phase_eval(torch, device_info) if "eval" in run else None
    tok = phase_tokenizer_train(torch, device_info) if "tokenizer_train" in run else None
    os.makedirs(OUT_DIR, exist_ok=True)
    if run != set(PHASES):
        with open(os.path.join(OUT_DIR, f"result_{os.path.basename(tree)}.json"), "w") as f:
            json.dump({"device": device_info, "kernel_rows": kern and kern["rows"],
                       "dropout_rows": drop, "slice": sl, "train_check": check, "train": tr,
                       "train_data": data, "eval": ev, "tokenizer_train": tok}, f, indent=1)
        log(f"[done] phases {args.phases} passed")
        return 0

    def row(name, source, replaces, launches, rows, **extra):
        first = rows[0]
        # phase 7 drives all four kernels again: its counts, read after its first run
        data_launches = data["launches"]["attention_block" if name == "fused_attention_block"
                                          else name]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "launches_train_data": data_launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": first["ms"], "call_ms": first["call_ms"], "plain_ms": first["plain_ms"],
                "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
                "library_ms": first.get("library_ms"), **extra}

    src = "maskbit_tpu_torch/csrc/dropout_attention.cu"
    pa = "maskbit_tpu/nn/pallas_attention.py"
    eval_row = kern["rows"][-1]  # the block at the eval shape (200, 257, 1024)
    record = {"kernels": [
        # no one PyTorch call computes the block: library_ms stays null, and
        # library_chain_ms is the chain of library calls
        row("fused_attention_block", "maskbit_tpu_torch/csrc/attention_block.cu", f"{pa}:532",
            sl["launches"], kern["rows"], library_chain_ms=kern["rows"][0]["library_chain_ms"],
            launches_eval=ev["launches"]["attention_block"],
            eval_shape={k: eval_row[k] for k in ("shape", "ms", "library_chain_ms", "plain_ms",
                                                 "bound_ms", "max_abs_err", "plan")}),
        row("dropout_attention_fwd", "maskbit_tpu_torch/csrc/attention_fwd.cuh", f"{pa}:232",
            tr["launches"]["dropout_attention_fwd"],
            drop["dropout_attention_fwd"]),
        row("dropout_attention_bwd", src, f"{pa}:274", tr["launches"]["dropout_attention_bwd"],
            drop["dropout_attention_bwd"]),
        # the attention block runs the dropout-free forward on every layer
        # of every step: its launches in the serve slice
        row("fused_attention", "maskbit_tpu_torch/csrc/attention_fwd.cuh", f"{pa}:94",
            sl["fused_attention_launches"], drop["fused_attention"],
            launches_eval=ev["launches"]["fused_attention"]),
    ]}
    idle = [k["name"] for k in record["kernels"]
            if k["launches"] <= 0 or k["launches_train_data"] <= 0
            or k.get("launches_eval", 1) <= 0]
    if idle:
        raise AssertionError(f"kernels of the main paths never launched there: {idle}")
    with open(os.path.join(OUT_DIR, "result.json"), "w") as f:
        json.dump({"device": device_info, "kernel_rows": kern["rows"], "dropout_rows": drop,
                   "slice": sl, "train_check": check, "train": tr, "train_data": data,
                   "eval": ev, "tokenizer_train": tok}, f, indent=1)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
