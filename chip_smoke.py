#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`maskbit_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py             # all phases, one card

Phases, each of which fails the run if it fails:
  1. device: require CUDA; print the card's name and power limit; switch
     TF32 off for the comparisons.
  2. build: compile the hand-written kernels from `maskbit_tpu_torch/csrc/`,
     one nvcc per source, all started together; print each kernel's ptxas
     registers and spill bytes (and any serialised-wgmma warning), and the
     attention kernels' plan at each head dim (shared memory, blocks an SM,
     the backward's Q/G stages and dQ-part buffers).
  3. kernels: the attention block's chain of kernels against its plain
     PyTorch version at the serving shapes (16, 257, 1024) and (2, 1025,
     1024), the eval shape (200, 257, 1024) and a split replica's share of
     the serve and the eval batch, (8, 257, 1024) and (100, 257, 1024)
     (phase 13), 16 heads, bf16 vectors as
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
     `scaled_dot_product_attention`; the same four kernels at the other
     head dims (the same templates' instantiations), at every multiple of
     16 in [16, 128] but 64 (`HEAD_DIM_SHAPES`: the dropout pair at batch
     32, the block and `fused_attention` at the system check's CFG batch
     60, or 16 at d = 128), each at n = 257 and n = 17 against its plain
     version (the mask bit for bit, dq, dk, dv; the tolerances of d = 64),
     at d = 16, 32 and 128 (`TIMED_HEAD_DIMS`; every one with
     `--all-widths`) timed at n = 257 beside SDPA (the block beside the
     library chain) and the bound, the CUDA kernels one call of each
     launches at every width (the whole run fails if a `*_mma*` kernel
     ran); the shapes the wrappers zero-pad (`PADDED_SHAPES`: head dims 8,
     72 and 125, each kernel at n = 257 and 17, the mask bit for bit, the
     launches counted at their own d; `PADDED_BLOCKS`: the block at E = 80
     and 4608) against their plain versions at the same tolerances; and
     head dim 144 refused by the kernels' wrappers (no instantiation holds
     it; the layers raise there on the card);
     then the flagship generator's logits
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
  8. eval, the flagship (hidden 1024, 64 steps, guidance 7.1 cosine, bf16;
     depth cut from 24 to `EVAL_DEPTH` = 6 to make room for phases 17 and
     18) and
     the 14-bit and VQ 12-bit tokenizers, random weights:
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
 10. variants (`--phases variants`): the Bert generator, the converter and
     the taming tokenizer, random weights:
     a. Bert (`maskbit_generator_12bit.yaml` with `model_cls=bert`: hidden
        1024, 16 heads, 4096 codes in 2 splits, bf16, `attention_impl:
        fused`) cut to depth 2: logits through the block kernel on the card
        against a float32 plain forward on the CPU (relative error 3e-2, as
        LFQBert's in phase 3);
     b. `cli.serve` with that Bert at depth 24, serve batch 8: three seeded
        8-label /generate requests (byte-identical), img/s, and the block
        and `fused_attention` on every layer of every step; LFQBert on the
        same config before it, for comparison;
     c. `cli.train_maskbit` with it, batch 32, 6 steps, synthetic data:
        finite losses, the dropout kernels on every layer and step,
        samples/s and peak memory; LFQBert likewise after the convert;
     d. `cli.convert_checkpoint` of that run's `model-6.bin` and of a random
        14-bit LFQ tokenizer `.bin`, `.bin` -> `.msgpack` -> `.bin`: equal
        key for key and bit for bit; the converted Bert's logits on the
        card equal the original's bit for bit; seconds and sizes;
     e. `cli.eval_tokenizer` on `configs/external/taming_vqgan_tokenizer.yaml`
        at its published widths over 4 batches of 16 synthetic 256 px
        images (every metric finite; img/s), one bf16 forward of 16 images
        timed, and one float32 forward on the card (TF32 off) against the
        CPU: tokens all equal, and the decode of the CPU's tokens within 1e-4.
     Its files live under build/chip_smoke_data/ and are deleted.
 11. distributed (`--phases distributed`): data-parallel runs across
     processes; the ranks are this script in `--worker` mode with
     torchrun's variables set by hand, two sharing the card over gloo
     (NCCL refuses two ranks on one device), each logging to
     chiprun_out/chip_smoke/distributed_<tag>_rank<r>.log:
     a. `cli.train_maskbit` on 2 ranks, the 14-bit flagship at full width
        (depth cut to 6) from 512 random token shards' tokens, per-rank batch 16
        (global 32), `save_every=3`; SIGTERM to rank 1 once step 4 is
        logged: both ranks stop on the same step, a multiple of 8 (the
        cross-process check), with the final save the newest committed
        step; a second pair resumes from it for one step. Per rank: the
        dropout kernels' launches (depth x steps each), the median step and
        the gradient all-reduce's time apart from the rest of the step;
     c. meanwhile one rank alone through `cli.train_maskbit`
        (`MASKBIT_DISTRIBUTED=1`, world size 1, depth 2, 3 steps): the
        backend is NCCL;
     b. in a second pair of ranks: one step of the flagship-width LFQBert
        (depth cut to 6, hidden dropout off, attention dropout 0.1, bf16) with
        injected global draws, 2 ranks x batch 16 against one process x
        batch 32 (this process, meanwhile): the reduced gradients' relative
        L2 gap and the updates' sign agreement, with `DP_GRAD_TOL`; each
        rank's train-state bytes and peak memory (phase 12's yardstick);
     d. the same ranks: `maskbit_tokenizer_14bit.yaml` (ResNet-50 from
        random weights) at per-rank batch 8, 4 steps across
        `discriminator_start=2`: every rank's parameters, EMA and LeCam
        state equal bit for bit after every step;
     e. the same ranks: `cli.eval_maskbit` on 300 samples at batch 100,
        the generator's depth cut to 6 (each rank's second batch half
        padding): 300 scored, the merged
        float64 moments within 1e-12 of the concatenated per-rank Inception
        features', and the block's and `fused_attention`'s launches per
        rank (depth x steps x 2 batches).
     Its files (about 15 GB) live under build/chip_smoke_data/ and are
     deleted.
 12. sharded (`--phases sharded`): the fsdp and tensor axes
     (`parallel/zero.py`), two ranks sharing the card over gloo, first at
     parallel.fsdp=2, then at tensor=2, each logging as phase 11's ranks:
     the flagship-width LFQBert at depth 6 (hidden dropout off, attention
     dropout 0.1, bf16), per-device batch 16 (global 32; under tensor=2
     both ranks hold the 32 rows, 8 heads each), 4 steps with injected
     global draws: the first update against one process x batch 32 on the
     card (the reduced gradients gathered whole: relative L2 and the
     updates' signs, `DP_GRAD_TOL`); the second with its all-gather,
     reduce-scatter and tensor all-reduce timed apart; per rank the
     train-state bytes (at most `SH_STATE_RATIO` of data=2's under fsdp=2,
     phase 11's when it ran), peak memory, step seconds and the dropout
     kernels' launches with the heads they ran on. Under fsdp=2: a save
     of the sliced state, resumed in this process bit for bit and stepped
     once, and the 14-bit tokenizer through `cli.train_tokenizer`'s
     `build_training` at fsdp=2 for 3 steps (the gate at 1): both ranks'
     gathered states equal after every step. Under tensor=2: 2 labels
     sampled on each rank with the whole EMA weights (the attention block
     on every layer), the layers tensor-parallel again afterwards. The
     kernels line gains `launches_sharded_per_rank`. Its files (about 5 GB)
     live under build/chip_smoke_sharded/ and are deleted.
 13. split (`--phases split`): one batch split over a host's devices
     (`sampling/serve.py`, a worker process per entry), over two entries
     that name the one card, and the native JPEG decoder:
     a. `make_sharded_sampler` on [cuda:0, cuda:0] (two worker processes,
        each with its own replica) with the flagship at full width (depth
        24, hidden 1024, 64 steps, bf16, random weights) at serve batch 8
        with injected draws: each replica's weights equal this process's
        bit for bit; the split equal bit for bit to two one-device calls at
        batch 4 on the same rows (else the largest gap and the tokens that
        differ, and a failure); beside the whole batch's call, the token
        agreement and the largest image gap (no gate: other GEMM shapes);
        the split's and the whole call's wall times; the workers' start-up;
        the kernels' launches counted in each worker, depth x steps each;
        no worker left once it is closed;
     b. `cli.serve` with `local_devices` patched to those two entries and
        `serve.shard_local_devices=true`: a seeded 8-label request twice,
        the same bytes, through the split, its workers' launches, and no
        worker left after the server's shutdown;
     c. `cli.eval_maskbit` in this process over the two entries
        (`eval.shard_local_devices=true`), 200 samples at batch 100, the
        generator's depth cut to 6 (random Inception weights): 200 scored, and
        depth x steps x 2 batches block launches in each worker;
     d. when g++ finds `jpeglib.h`: the native decoder built, 256 synthetic
        500 x 375 JPEGs written with `data/shard_writer`, img/s of the
        `thread` (PIL) and `native` backends at batch 32 with 1 and 8
        decode threads (the config's crop, flip and filter), beside phase
        6's Stage-II step when it ran; native against PIL within JAX's
        tolerances (per image mean gap under 0.01, 0.012 bicubic), labels
        and order equal. Without the header: one line, and the run goes on.
     The kernels line gains `launches_split_per_replica` (per worker).
 14. split_scale (`--phases split_scale`, on a host with several cards):
     the flagship's sampler at the serve batch 8 and the eval batch 100
     split over 2, 4, ... distinct cards (`make_sharded_sampler` over
     cuda:0..n-1, a worker process a card), the wall time of a call beside
     the whole batch's on cuda:0 and one call on cuda:0 at a replica's rows
     (injected draws); the first replica bit for bit against that call;
     the workers' start-up and launches. With one card (the default run)
     it prints that it was not timed. The kernels line gains
     `launches_split_scale_per_worker` (null with one card).
 15. multicard (`--phases multicard`, on a host with four cards): one
     rank a card, NCCL between them (`MC_SIZES`); the ranks are this script
     in `--worker` mode, as phase 11's, and every launch has a deadline
     after which, or after one rank fails, every rank is killed:
     a. `cli.train_maskbit` at data=4, the flagship at full width and depth
        from random token shards, batch 32 a rank: SIGTERM to rank 3 once
        step 4 is logged, every rank stops on step 8 with its save the
        newest committed; four ranks resume for one step. Per rank the
        backend, the step and the gradient all-reduce's seconds, peak
        memory and the dropout kernels' launches;
     c. four ranks at data=4: one step at depth 24 with injected global
        draws, 16 rows a rank, against one process at batch 64 (this
        process, meanwhile; `DP_GRAD_TOL`); the 14-bit tokenizer at batch
        16 a rank across `discriminator_start=2` (every rank's state equal
        after every step); `cli.eval_maskbit` on 1000 samples at batch 100
        over the four ranks: the merged moments and Inception Score against
        one accumulator fed every rank's features and logits at their
        global indices, img/s, and the block's launches per rank;
     b. fsdp=2 x tensor=2 on the four ranks, depth 24, 16 rows a batch
        shard (8 heads a rank): the first update against one process at
        batch 32 (`DP_GRAD_TOL`), the all-gather, reduce-scatter and
        all-reduces of steps 2 to 6 timed apart, those of steps 3 and 5
        with half types left in half precision (the staging's cost); per rank
        train-state bytes and peak memory beside c's data=4; 2 labels
        sampled with the whole EMA weights through the attention block.
     Each part runs even when another failed; every rank must report NCCL.
     With fewer than four cards it prints that it was not run. The
     kernels line gains `launches_multicard_per_rank` (null then).
 16. system_check (`--phases system_check`): `maskbit_tpu_torch.cli.system_check`
     on the card, both runs (the counterpart of `tools/system_check.py`):
     Stage I, 400 steps at batch 32 (recon must fall below 0.2x its first
     value), then per run 600 Stage-II steps and 30 CFG samples whose
     quadrant colours must match their classes (MSE below 0.35x chance):
     `tool` at the tool's widths (head dim 32: the kernels' d = 32
     instantiations) and `flagship` at the flagship generator's width (head dim 64), its depth
     cut to 6 (`SYSTEM_CHECK_FLAGSHIP_DEPTH`; the CLI's own run is at 24).
     One line a run: recon first and last, mlm loss, masked accuracy,
     matched and chance MSE, seconds a stage, and the dropout forward,
     backward and block launches of the run by head dim. The kernels line
     gains the other widths' entries (`*_other_widths`, with
     `kernels_by_width`, the CUDA kernels by name; launches: run `tool`)
     and `launches_system_check` (run `flagship`) on the d = 64 ones.
 17. float32 (`--phases float32`; run right after phase 3, as CUPTI loses
     profile events late in a long process): the
     float32 forms of the four kernels
     (`csrc/attention_f32.cu`; the plain versions in full float32, TF32
     off), as
     `training.mixed_precision: no` runs them:
     a. each against its plain version in float32 on the card at every
        head dim and n = 257 and 17 (the dropout pair at batch 32, the
        block and `fused_attention` at the serve batch's CFG 16 at d = 64,
        else phase 3's `HEAD_DIM_SHAPES`), and at phase 3's padded shapes:
        every output, dq, dk and dv within `F32_TOL` of the largest
        reference value, the keep mask bit for bit; timed at n = 257 at
        head dims 32, 64 and 128 beside SDPA in float32 (the block beside
        the float32 library chain) and the bound both ways (`_bound_f32`:
        the products as 3xTF32 on the tensor cores, and as FFMA); the
        3xTF32 kernels' ptxas registers and spill bytes (the forward
        `attn_fwd_tf32_kernel`, the backward, the projections and the
        weight split); float16 and float64 refused;
     b. a profile of one float32 block call, one serving-mode BertAttention
        call and one dropout-attention forward and backward: their float32
        kernels (`split_tf32_kernel`, `proj_tf32_kernel`,
        `attn_fwd_tf32_kernel`, `attn_bwd_tf32_kernel`), no library GEMM or
        attention kernel and no bf16 one;
     c. phase 5's depth-2 step with the kernels in float32 against the CPU's
        float32 step (`F32_STEP_TOL`);
     d. `cli.train_maskbit` on the flagship config with
        `training.mixed_precision=no`, batch 32, 4 steps with
        `generate_every=3`: finite losses, the EMA sample grid, and the
        float32 kernels only (counts by kernel, head dim and dtype zeroed
        before the run): the dropout pair on every layer of every step, the
        block on every layer of every sampling step;
     e. `cli.serve` at `training.mixed_precision=no`: one seeded /generate
        of 8 labels, the float32 block on every layer of every step and
        nothing in bf16.
     The kernels line gains the four `*_f32` rows, each naming its CUDA
     kernels (`cuda_kernels`).
Not in the default run, `--phases f32_error` (with `--tree` to compare
trees in one call): the float32 block's, forward's (out and lse) and
backward's error against float64 as the contraction grows (the block's E
up to 8192, the forward's and backward's n up to 4097), beside the plain
float32 version's, and their device ms.
Where one sampler call's time goes is `maskbit_tpu_torch.cli.profile_sampler`.
The next-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. Longer logs go to chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import io
import json
import logging
import os
import re
import shutil
import signal
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
# eval_maskbit's default batch; 1000 samples = 10 batches; the generator's
# depth in phase 8 (cut from 24 to make room for phase 17, then to 6 for
# phase 18)
EVAL_BATCH, EVAL_SAMPLES, STATS_IMAGES, EVAL_TOKENIZER_BATCHES = 100, 1000, 512, 4
EVAL_DEPTH = 6
TOKENIZER_CONFIGS = tuple(os.path.join(ROOT, "configs", "tokenizer", name)
                          for name in ("maskbit_tokenizer_14bit.yaml", "vqgan_plus_12bit.yaml"))
TOKENIZER_18 = os.path.join(ROOT, "configs", "tokenizer", "maskbit_tokenizer_18bit.yaml")
# phase 9: Stage-I steps, the discriminator's gate, saves, eval batches, the resume
TOK_STEPS, TOK_GATE, TOK_SAVE, TOK_EVAL_BATCHES, TOK_RESUME = 6, 3, 3, 2, 8
# phase 10: Bert is the 12-bit config's generator with this one override
BERT_CONFIG = os.path.join(ROOT, "configs", "generator", "maskbit_generator_12bit.yaml")
TAMING_CONFIG = os.path.join(ROOT, "configs", "external", "taming_vqgan_tokenizer.yaml")
TAMING_BATCHES = 4
# phase 11: two ranks share the card. Stage-II per-rank batch (global 32),
# the stop run's depth (cut from 24 to make room for phase 12), the gradient
# check's depth (cut from 24, as phase 12's, to make room for phase 16; phase
# 12 compares its train state with these ranks'), the NCCL rank's depth and
# steps, Stage I's per-rank batch, steps and gate, the sharded eval (its
# generator's depth cut from 24 to make room for phase 17), each launch's
# limit (s); the three depths cut from 12 to 6 to make room for phase 18
DP_SIZES = {"batch": 16, "stop_depth": 6, "grad_depth": 6, "nccl_depth": 2, "nccl_steps": 3,
            "tok_batch": 8,
            "tok_steps": 4, "tok_gate": 2, "eval_samples": 300, "eval_batch": 100,
            "eval_depth": 6, "timeout": 600}
DP_CHECK_EVERY = 8  # GracefulShutdown's cross-process check, as the train CLIs use it
# b: two ranks' reduced gradients against one process's, relative L2 over
# every gradient. In bf16 the ranks' linears see 16 rows where one process
# sees 32 (other cuBLAS tiles, other summation order) and the mean over 32
# rows is summed in another order: a few 1e-3 are expected, 1e-2 allowed.
# Adam's first update is lr * g / (|g| + eps), so its sign follows g: the
# updates' signs agree wherever |g| stands above that noise (99% of them).
# In float32 on the CPU only the summation order differs.
DP_GRAD_TOL = {"grad_rel_l2": 1e-2, "update_same_sign": 0.99}
DP_GRAD_TOL_CPU = {"grad_rel_l2": 1e-5, "update_same_sign": 0.999}
# phase 13: the serve batch split in two, the eval samples and batch, the
# synthetic 500 x 375 JPEGs, the reader's batch and output size
# (the eval's generator depth cut from 24 to make room for phase 17, then to
# 6 for phase 18)
SPLIT_SIZES = {"batch": SERVE_BATCH, "eval_samples": 200, "eval_batch": 100, "eval_depth": 6,
               "photos": 256, "decode_batch": 32,
               "decode_res": None}  # None: the config's resolution
# phase 14: the serve and the eval batch split over the visible cards, and
# the timed calls of each setting (after one warm-up)
SCALE_SIZES = {"batches": (SERVE_BATCH, EVAL_BATCH), "calls": 2}
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

    names = cuda_build.sources()
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
            if "wgmma" in line:  # a serialised wgmma, with its reason
                log(f"[build] ptxas: {line.strip()}")
        for k in ptxas_kernels(info["ptxas"]):
            log(f"[build] ptxas {name}: {k['kernel']}: {k['registers']} registers, spill "
                f"stores {k['spill_stores']} B, spill loads {k['spill_loads']} B, static smem "
                f"{k['smem']} B")
    from maskbit_tpu_torch.nn import dropout_attention as da

    for d in da.HEAD_DIMS if hasattr(da, "kernel_plan") else ():  # a --tree from before it
        plan = da.kernel_plan(d)
        log(f"[build] attention plan d={d}: forward {plan['fwd_smem']} B dynamic smem, at least "
            f"{plan['fwd_min_blocks']} blocks an SM; backward {plan['bwd_smem']} B, "
            f"{plan['bwd_blocks']} blocks an SM, {plan['bwd_qg_stages']} Q/G stages, "
            f"{plan['bwd_dq_buffers']} dQ-part buffers")
    for d in da.HEAD_DIMS if hasattr(da, "kernel_plan_f32") else ():
        plan = da.kernel_plan_f32(d)
        log(f"[build] float32 backward plan d={d}: {plan['smem']} B dynamic smem, "
            f"{plan['blocks']} blocks an SM, {plan['queries_a_step']} queries a step, "
            f"{plan['qg_stages']} Q/G stages, {plan['dq_buffers']} dQ-part buffers")
        if "fwd_smem" in plan:  # a --tree from before the 3xTF32 forward lacks it
            log(f"[build] float32 forward plan d={d}: {plan['fwd_smem']} B dynamic smem, "
                f"{plan['fwd_warpgroups']} consumer warpgroups of 64 queries, "
                f"{plan['fwd_keys_a_tile']} keys a tile")


def ptxas_kernels(text: str) -> list:
    """Per kernel of a `ptxas -v` report: its name (demangled by c++filt
    where there is one, without its parameters), registers, spill bytes and
    static shared memory."""
    rows, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": m.group(1), "registers": None, "spill_stores": None,
                   "spill_loads": None, "smem": 0}
            rows.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                cur["smem"] = int(m.group(1))
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r["kernel"] for r in rows),
                             capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(out) == len(rows):
            for r, name in zip(rows, out):
                r["kernel"] = _kernel_name(name)
    return rows


def _bound(flops: float, nbytes: float, peak_flops: float = PEAK_FLOPS) -> dict:
    """The least time the card could take: operations at the bf16 peak (or
    `peak_flops`) or bytes at the memory rate, whichever is longer."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
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


def _device_breakdown(torch, fn, iters: int = 50, warmup: int = 3, tries: int = 3) -> dict:
    """Device time per call of each CUDA kernel (and memset or copy) that
    `iters` calls of fn launched under torch.profiler: its summed
    `self_device_time_total` over `iters`, by name. CUPTI sometimes
    records nothing (more often late in a long process):
    a profile that recorded no device time is taken again, up to `tries`
    times; then the calls are timed by CUDA events instead, under the one
    name `EVENTS_KEY`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = {ev.key: ev.self_device_time_total / 1e3 / iters for ev in prof.key_averages()
                 if ev.device_type == DeviceType.CUDA}
        if sum(times.values()) > 0:
            return times
        log(f"[profile] the profiler recorded no device time (try {attempt + 1} of {tries})")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    log("[profile] timed by CUDA events over back-to-back calls instead")
    return {EVENTS_KEY: start.elapsed_time(end) / iters}


# `_device_breakdown`'s one key when the profiler recorded nothing
EVENTS_KEY = "(CUDA events, all kernels)"


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


def _block_inputs(torch, b, n, e, seed, vectors, dtype=None):
    """x and the weights in `dtype` (default bf16), the vectors in `vectors`."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev, dt = "cuda", dtype or torch.bfloat16

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    x = torch.nn.functional.layer_norm(rnd(b, n, e), (e,)).to(dt)
    w_qkv = rnd(3 * e, e, std=0.02).to(dt)  # torch (out, in) layout
    w_o = rnd(e, e, std=0.02).to(dt)
    return dict(x=x, wqkv=w_qkv.t(), bqkv=rnd(3 * e, std=0.02).to(vectors), wo=w_o.t(),
                bo=rnd(e, std=0.02).to(vectors), ln_scale=(1.0 + rnd(e, std=0.02)).to(vectors),
                ln_bias=rnd(e, std=0.02).to(vectors))


def _library_chain(torch, inp, heads):
    """The block as a chain of library calls on the same weights, in x's
    dtype: cuBLAS QKV projection, `scaled_dot_product_attention`, cuBLAS
    out-projection plus the residual, `F.layer_norm` (the yardstick: no one
    PyTorch call computes the block)."""
    F = torch.nn.functional
    x = inp["x"]
    b, n, e = x.shape
    w_qkv, w_o = inp["wqkv"].t(), inp["wo"].t()
    bqkv, bo, g, beta = (inp[k].to(x.dtype) for k in ("bqkv", "bo", "ln_scale", "ln_bias"))

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
    # the serve batch with CFG, the 512 px sequence, the eval batch with CFG,
    # and each of those two batches split in two (phase 13's replicas)
    for b, n in ((2 * SERVE_BATCH, 257), (2, 1025), (2 * EVAL_BATCH, 257), (SERVE_BATCH, 257),
                 (EVAL_BATCH, 257)):
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


def _qkv_packed(torch, b, n, h, seed, d=64, dtype=None):
    """q, k, v in `dtype` (default bf16) as the QKV projection's views of one
    (b, n, 3, h, d)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, n, 3, h, d, generator=g, device="cuda").to(dtype or torch.bfloat16)
    return qkv.unbind(2)


def _sdpa(torch, q, k, v, dropout_p):
    """torch's fused attention on the (b, h, n, d) views: the yardstick."""
    f = torch.nn.functional.scaled_dot_product_attention
    return f(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), dropout_p=dropout_p)


def kernel_keep_mask(torch, da, seeds, b, n, h, d=64, dtype=None):
    """The forward kernel's keep mask at head dim d for inputs of `dtype`
    (default bf16), read out exactly: at zero logits every kept weight is
    positive and every dropped one 0, so with V one-hot over the head dim
    for d keys at a time, out[b, i, h, j] > 0 iff key (chunk + j) is kept
    for query i."""
    dt = dtype or torch.bfloat16
    z = torch.zeros(b, n, h, d, device="cuda", dtype=dt)
    seeds32 = da.seeds_as_int32(seeds, (b, h))
    keep = torch.empty(b, h, n, n, device="cuda", dtype=torch.bool)
    for c0 in range(0, n, d):
        m = min(d, n - c0)
        v = torch.zeros_like(z)
        v[:, c0:c0 + m, :, :m] = torch.eye(m, device="cuda", dtype=dt)[:, None, :]
        out = da.launch_forward(z, z, v, seeds32, RATE)[0]
        keep[..., c0:c0 + m] = (out[..., :m] > 0).permute(0, 2, 1, 3)
    return keep


def phase_dropout_kernels(torch) -> dict:
    """The dropout-attention forward and backward kernels and the
    dropout-free `fused_attention` against their plain versions."""
    from maskbit_tpu_torch.nn import dropout_attention as da

    rows = {"dropout_attention_fwd": [], "dropout_attention_bwd": [], "fused_attention": []}
    # the train shape, the 512 px one, and a rank's share of the heads in
    # phase 12's tensor=2 steps (the global batch of 32 rows, 8 heads)
    for b, n, h in ((TRAIN_BATCH, 257, HEADS), (LONG_BATCH, 1025, HEADS),
                    (2 * SH_SIZES["batch"], 257, HEADS // 2)):
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


# The other head dims' kernels in phase 3: per d, (heads, the dropout
# pair's batch, the block's and fused_attention's batch, the block's E).
# 32 is the system check's generator (its CFG batch of 60 samples), 16 the
# JAX package's tests (E = 64 over 4 heads), 128 the flagship's width over 8
# heads; 48, 80, 96 and 112, where d / 16 is odd, are checked, not timed.
# Past the narrow templates (bf16: csrc/attention_wide_bf16.cuh's TMA and
# wgmma kernels; float32: csrc/attention_wide_f32.cuh's 3xTF32 ones): 192
# (hidden 1536 over 8 heads) and 256 (the flagship's hidden 1024 over 4
# heads, phase 18's), both timed.
HEAD_DIM_SHAPES = {16: (4, TRAIN_BATCH, 60, 64), 32: (4, TRAIN_BATCH, 60, 128),
                   48: (4, TRAIN_BATCH, 60, 192), 80: (4, TRAIN_BATCH, 60, 320),
                   96: (4, TRAIN_BATCH, 60, 384), 112: (8, TRAIN_BATCH, 60, 896),
                   128: (8, TRAIN_BATCH, 2 * SERVE_BATCH, 1024),
                   192: (8, TRAIN_BATCH, 2 * SERVE_BATCH, 1536),
                   256: (4, TRAIN_BATCH, 2 * SERVE_BATCH, 1024)}
WIDE_TIMED_HEAD_DIMS = (192, 256)
TIMED_HEAD_DIMS = (16, 32, 128, *WIDE_TIMED_HEAD_DIMS)
# the lengths each width is held at, up to 128 and past it (where
# `WIDE_SHAPES` holds n = 17)
WIDTH_LENGTHS = {False: (257, 17), True: (257,)}
# head dims past 128 held against the plain versions at small shapes in both
# dtypes (phases 3 and 17), as `PADDED_SHAPES`: 144 and 200 pad to widths
# below the instantiations (192, 256) and not multiples of the 64-wide
# chunks, 320 takes two 256-wide output panels (and three of float32's
# 128-wide dK and dV panels), 1024 is one head of E = 1024
WIDE_SHAPES = {144: (2, 4, 2, 288), 200: (2, 4, 2, 400), 256: (4, 4, 2, 1024),
               320: (2, 4, 2, 640), 1024: (1, 4, 2, 1024)}


def _wide_bf16_forms(kernel: str, flag: str) -> list:
    """attention_wide_bf16.cuh's instantiations of `kernel` with `flag`
    (dropout, or the dQ pass): widths 192 and 256, and 256 streamed past
    d = 256. The forward's last template argument is its warpgroups (its
    `wide_fwd_warpgroups`): one when streamed and at 256 without dropout,
    else two."""
    def forward_wgs(w, stream):
        return f", {1 if stream or (w == 256 and flag == 'false') else 2}"

    extra = forward_wgs if "fwd" in kernel else (lambda *_: "")
    return [f"{kernel}<{w}, {flag}, {str(stream).lower()}{extra(w, stream)}>"
            for w, stream in ((192, False), (256, False), (256, True))]


def _wide_f32_forward(dropout: str) -> list:
    """attention_wide_f32.cuh's forward instantiations with `dropout`:
    widths 192 and 256, and 256 streamed past d = 256."""
    return [f"attn_fwd_wide_tf32_kernel<{w}, {dropout}, {stream}>"
            for w, stream in ((192, "false"), (256, "false"), (256, "true"))]


# the kernels past 128 by row of the final record and dtype: bf16's TMA and
# wgmma kernels (csrc/attention_wide_bf16.cuh: the forward with one or two
# warpgroups, the backward's dK/dV and dQ kernels after the row stats),
# float32's 3xTF32 ones (csrc/attention_wide_f32.cuh: the forward at widths
# 192 and 256 and streamed, the backward's dK/dV (false) and dQ (true)
# kernels after the row stats, each resident or streamed)
WIDE_CUDA_KERNELS = {
    "fused_attention_block": {"bf16": _wide_bf16_forms("attn_fwd_wide_bf16_kernel", "false"),
                              "float": _wide_f32_forward("false")},
    "dropout_attention_fwd": {"bf16": _wide_bf16_forms("attn_fwd_wide_bf16_kernel", "true"),
                              "float": _wide_f32_forward("true")},
    "dropout_attention_bwd": {
        "bf16": ["attn_bwd_wide_prep_kernel<bf16>"]
        + _wide_bf16_forms("attn_bwd_wide_bf16_kernel", "false")
        + _wide_bf16_forms("attn_bwd_wide_bf16_kernel", "true"),
        "float": ["attn_bwd_wide_prep_kernel<float>"]
        + [f"attn_bwd_wide_tf32_kernel<{dq}, {stream}>" for stream in ("false", "true")
           for dq in ("false", "true")]},
    "fused_attention": {"bf16": _wide_bf16_forms("attn_fwd_wide_bf16_kernel", "false"),
                        "float": _wide_f32_forward("false")}}
# the panelled mma.sync kernels that ran past head dim 128 before the TMA and
# wgmma ones (bf16) and the 3xTF32 wgmma ones (float32): none may run
WIDE_MMA_SYNC_KERNELS = ("attn_fwd_wide_kernel", "attn_bwd_wide_kernel")


def phase_head_dims(torch, timed_dims=TIMED_HEAD_DIMS) -> dict:
    """The four kernels at every head dim but 64 against their plain
    versions at n = 257 and n = 17 (past 128 at 257: `WIDTH_LENGTHS`),
    timed at n = 257 at `timed_dims`, and
    the CUDA kernels one call of each launches at n = 257 (`kernels`); the
    padded head dims and `WIDE_SHAPES` checked; the serving and training
    layers run at head dim 144; the ptxas report of the kernels past 128 (0
    spilled bytes)."""
    from maskbit_tpu_torch.nn import attention_block as ab
    from maskbit_tpu_torch.nn import dropout_attention as da

    rows = []
    for d, (h, b, bb, e) in HEAD_DIM_SHAPES.items():
        for n in WIDTH_LENGTHS[d > 128]:
            q, k, v = _qkv_packed(torch, b, n, h, seed=d * n, d=d)
            seeds = torch.randint(0, 2**32, (b, h), device="cuda", dtype=torch.int64,
                                  generator=torch.Generator(device="cuda").manual_seed(d + n))
            seeds32 = da.seeds_as_int32(seeds, (b, h))
            g = torch.randn(b, n, h, d, generator=torch.Generator(device="cuda").manual_seed(n),
                            device="cuda").to(torch.bfloat16)
            out, lse = da.launch_forward(q, k, v, seeds32, RATE)
            grads = da.launch_backward(q, k, v, out, lse, g, seeds32, RATE)
            torch.cuda.synchronize()
            qf, kf, vf = q.float(), k.float(), v.float()
            fwd_err = (out.float() - da.dropout_attention_reference(qf, kf, vf, seeds, RATE)
                       ).abs().max().item()
            refs = da.dropout_attention_backward_reference(qf, kf, vf, g.float(), seeds, RATE)
            bwd_errs = [(x.float() - r).abs().max().item() for x, r in zip(grads, refs)]
            bwd_tol = DROPOUT_ATOL * max(1.0, max(r.abs().max().item() for r in refs))
            mask_flips = int((kernel_keep_mask(torch, da, seeds, b, n, h, d)
                              != da.hash_keep_mask(seeds, n, RATE)).sum().item())
            fq, fk, fv = _qkv_packed(torch, bb, n, h, seed=d * n + 1, d=d)
            fused = da.fused_attention(fq, fk, fv)
            fused_err = (fused.float() - da.fused_attention_reference(
                fq.float(), fk.float(), fv.float())).abs().max().item()
            inp = _block_inputs(torch, bb, n, e, seed=d * n + 2, vectors=torch.bfloat16)
            block = ab.fused_attention_block(**inp, num_heads=e // d)
            torch.cuda.synchronize()
            block_err = (block.float() - ab.fused_attention_block_reference(
                **{x: y.float() for x, y in inp.items()}, num_heads=e // d)).abs().max().item()
            finite = all(bool(torch.isfinite(x).all()) for x in (out, *grads, fused, block))
            row = dict(d=d, n=n, heads=h, dropout_shape=[b, n, h, d], block_shape=[bb, n, e],
                       fused_shape=[bb, n, h, d],
                       fwd_err=fwd_err, bwd_errs=bwd_errs, bwd_tol=bwd_tol,
                       mask_flips=mask_flips, fused_err=fused_err, block_err=block_err)
            log(f"[kernel] head dim {d}, n {n}: dropout ({b}, {n}, {h}, {d}) fwd max_abs_err "
                f"{fwd_err:.6f}, dq/dk/dv {bwd_errs[0]:.6f}/{bwd_errs[1]:.6f}/{bwd_errs[2]:.6f} "
                f"(atol {DROPOUT_ATOL}, bwd {bwd_tol:.4f}), keep mask {mask_flips} of "
                f"{b * h * n * n} bits differ; fused_attention ({bb}, {n}, {h}, {d}) "
                f"{fused_err:.6f}; block ({bb}, {n}, {e}) {e // d} heads {block_err:.6f} "
                f"(atol {KERNEL_ATOL})")
            if (not finite or fwd_err > DROPOUT_ATOL or max(bwd_errs) > bwd_tol or mask_flips
                    or fused_err > DROPOUT_ATOL or block_err > KERNEL_ATOL):
                raise AssertionError(f"the kernels disagree at head dim {d}, n {n}: {row}")
            if n == 257:  # at every width, the CUDA kernels one call of each launches
                calls = {"dropout_attention_fwd": lambda: da.launch_forward(q, k, v, seeds32, RATE),
                         "dropout_attention_bwd": lambda: da.launch_backward(
                             q, k, v, out, lse, g, seeds32, RATE),
                         "fused_attention": lambda: da.fused_attention(fq, fk, fv),
                         "fused_attention_block": lambda: ab.fused_attention_block(
                             **inp, num_heads=e // d)}
                row["kernels"] = {name: sorted({_kernel_name(x) for x in _device_breakdown(
                    torch, fn, iters=5, warmup=1)}) for name, fn in calls.items()}
                log(f"[kernel]   head dim {d} CUDA kernels: " + "; ".join(
                    f"{name} {', '.join(ks)}" for name, ks in row["kernels"].items()))
            if n == 257 and d in timed_dims:
                lib_g = g.transpose(1, 2)
                ql, kl, vl = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
                lib_out = _sdpa(torch, ql, kl, vl, RATE)
                elems = b * n * h * d
                row["dropout_attention_fwd"] = dict(
                    **_times(torch, lambda: da.launch_forward(q, k, v, seeds32, RATE),
                             plain=lambda: da.dropout_attention_reference(q, k, v, seeds, RATE),
                             library=lambda: _sdpa(torch, q, k, v, RATE)),
                    **_bound(4 * b * h * n * n * d, 2 * 4 * elems + 4 * b * h * n))
                row["dropout_attention_bwd"] = dict(
                    **_times(torch, lambda: da.launch_backward(q, k, v, out, lse, g, seeds32,
                                                               RATE),
                             plain=lambda: da.dropout_attention_backward_reference(
                                 q, k, v, g, seeds, RATE),
                             library=lambda: torch.autograd.grad(lib_out, (ql, kl, vl), lib_g,
                                                                 retain_graph=True)),
                    **_bound(10 * b * h * n * n * d, 2 * 8 * elems + 4 * b * h * n))
                row["fused_attention"] = dict(
                    **_times(torch, lambda: da.fused_attention(fq, fk, fv),
                             plain=lambda: da.fused_attention_reference(fq, fk, fv),
                             library=lambda: _sdpa(torch, fq, fk, fv, 0.0)),
                    **_bound(4 * bb * h * n * n * d, 2 * 4 * bb * n * h * d))
                call = lambda: ab.fused_attention_block(**inp, num_heads=e // d)  # noqa: E731
                row["fused_attention_block"] = dict(
                    **_times(torch, call, plain=lambda: ab.fused_attention_block_reference(
                        **inp, num_heads=e // d)),
                    library_chain_ms=_device_ms(torch, _library_chain(torch, inp, e // d)),
                    **_bound(2 * bb * n * e * 3 * e + 2 * bb * n * e * e
                             + 4 * bb * (e // d) * n * n * d,
                             2 * (2 * bb * n * e + 4 * e * e) + 2 * 6 * e))
                log(f"[kernel]   head dim {d} device ms (per call by events; plain; library; "
                    "bound): " + "; ".join(
                        f"{name} {t['ms']:.4f} ({t['call_ms']:.4f}; {t['plain_ms']:.4f}; "
                        f"{t.get('library_ms', t.get('library_chain_ms')):.4f}; "
                        f"{t['bound_ms']:.4f} by {t['bound_by']})"
                        for name, t in row.items() if isinstance(t, dict) and "ms" in t))
                del lib_out, ql, kl, vl
            rows.append(row)
            del q, k, v, g, out, lse, grads, refs, fq, fk, fv, fused, inp, block
    # head dims that are not multiples of 16, and widths E that are not
    # multiples of 64 or exceed 4096: the kernels run them zero-padded
    # (`PADDED_SHAPES`, `PADDED_BLOCKS`), against the plain versions
    padded = [_padded_check(torch, d, n, shapes, torch.bfloat16)
              for d, shapes in PADDED_SHAPES.items() for n in (257, 17)]
    padded += [_padded_block_check(torch, b, n, e, heads, torch.bfloat16)
               for b, n, e, heads in PADDED_BLOCKS]
    wide = [_padded_check(torch, d, n, shapes, torch.bfloat16)
            for d, shapes in WIDE_SHAPES.items() for n in (257, 17)]
    return {"rows": rows, "padded": padded, "wide": wide, "layers": _wide_layers(torch),
            "ptxas": _wide_ptxas()}


def _wide_layers(torch) -> dict:
    """The layers that call the kernels, in bf16 at head dim 144 (E = 288
    over 2 heads): BertAttention's serving block and MultiHeadSelfAttention's
    fused dropout attention, forward and backward, each on its kernels
    (launches counted at 144) with finite values."""
    from maskbit_tpu_torch.nn import attention_block as ab
    from maskbit_tpu_torch.nn.transformer import (BertAttention, DropoutRng,
                                                  MultiHeadSelfAttention)

    d = 144
    serving = BertAttention(2 * d, 2, attention_impl="fused").to("cuda", torch.bfloat16).eval()
    training = MultiHeadSelfAttention(2 * d, 2, attention_dropout=RATE, fused_dropout=True).to(
        "cuda", torch.bfloat16).train()
    gen = torch.Generator(device="cuda").manual_seed(d)
    with torch.no_grad():  # the layers' weights start uninitialised
        for p in (*serving.parameters(), *training.parameters()):
            p.copy_(torch.randn(p.shape, device="cuda", generator=gen) * 0.05)
    x = torch.randn(1, 17, 2 * d, device="cuda", generator=gen).to(
        torch.bfloat16).requires_grad_(True)
    ab.reset_launch_counts()
    with torch.no_grad():
        served = serving(x)
    trained = training(x, DropoutRng(attention_seeds=[[[1, 2]]]))
    trained.float().sum().backward()
    torch.cuda.synchronize()
    launched = ab.launch_counts()["by_dtype"]
    want = {f"{key}@{d}/bfloat16": 1 for key in ("attention_block", "fused_attention",
                                                  "dropout_attention_fwd", "dropout_attention_bwd")}
    finite = all(bool(torch.isfinite(t).all()) for t in (served, trained, x.grad))
    log(f"[kernel] head dim {d} layers: BertAttention (serving) and MultiHeadSelfAttention "
        f"(training, forward and backward) on the card, finite {finite}, launches {launched}")
    if not finite or launched != want:
        raise AssertionError(f"the layers at head dim {d}: finite {finite}, launches {launched}")
    ab.reset_launch_counts()
    return {"d": d, "launches": launched}


def _wide_ptxas() -> list:
    """ptxas's registers and spill bytes of the kernels past head dim 128
    (attention_wide_bf16.cuh, attention_wide_f32.cuh, attention_wide.cuh's
    row stats) in every library that builds them, logged; raises on a
    spill."""
    from maskbit_tpu_torch.nn import cuda_build

    rows = [dict(k, library=name) for name in cuda_build.sources()
            for k in ptxas_kernels(cuda_build.build_log[name]["ptxas"]) if "_wide" in k["kernel"]]
    for k in rows:
        log(f"[kernel] ptxas {k['library']}: {k['kernel']}: {k['registers']} registers, spill "
            f"stores {k['spill_stores']} B, spill loads {k['spill_loads']} B")
    if not rows:  # a library loaded from an earlier build has no report
        log("[kernel] ptxas: no report of the kernels past 128 (libraries built before)")
    spilled = [k for k in rows if k["spill_stores"] or k["spill_loads"]]
    if spilled:
        raise AssertionError(f"the kernels past 128 spill: {spilled}")
    return rows


# The shapes outside the kernels' native set that phases 3 and 17 hold
# against the plain versions (zero-padded by the wrappers): per head dim d
# that is not a multiple of 16, (heads, the dropout pair's batch, the
# block's and fused_attention's batch, the block's E): 72 is hidden 1152
# over 16 heads, which JAX trains and serves; 8 and 125 the narrowest and
# the widest padding. And blocks (b, n, E, heads) whose E is not a multiple
# of 64 (80 over 5 heads of 16) or exceeds 4096 (4608 over 36 heads of 128).
PADDED_SHAPES = {8: (4, 8, 8, 32), 72: (16, 8, 2 * SERVE_BATCH, 1152), 125: (2, 8, 8, 250)}
PADDED_BLOCKS = ((2, 257, 80, 5), (2, 257, 4608, 36))


def _padded_check(torch, d, n, shapes, dtype) -> dict:
    """The dropout pair, `fused_attention` and the block at head dim d (not
    a multiple of 16, or past 128) and length n against their plain
    versions, in `dtype` (bf16 at phase 3's tolerances, float32 at
    `F32_TOL`), the keep mask bit for bit; the launches counted at d."""
    from maskbit_tpu_torch.nn import attention_block as ab
    from maskbit_tpu_torch.nn import dropout_attention as da

    h, b, bb, e = shapes
    f32 = dtype is torch.float32
    q, k, v = _qkv_packed(torch, b, n, h, seed=d * n + 7, d=d, dtype=dtype)
    seeds = torch.randint(0, 2**32, (b, h), device="cuda", dtype=torch.int64,
                          generator=torch.Generator(device="cuda").manual_seed(d + n + 2))
    seeds32 = da.seeds_as_int32(seeds, (b, h))
    g = torch.randn(b, n, h, d, generator=torch.Generator(device="cuda").manual_seed(n + 3),
                    device="cuda").to(dtype)
    before = dict(da.launches_by_dtype)
    out, lse = da.launch_forward(q, k, v, seeds32, RATE)
    grads = da.launch_backward(q, k, v, out, lse, g, seeds32, RATE)
    again = da.launch_backward(q, k, v, out, lse, g, seeds32, RATE)
    fq, fk, fv = _qkv_packed(torch, bb, n, h, seed=d * n + 8, d=d, dtype=dtype)
    fused = da.fused_attention(fq, fk, fv)
    inp = _block_inputs(torch, bb, n, e, seed=d * n + 9, vectors=torch.float32 if f32 else
                        torch.bfloat16, dtype=dtype)
    block = ab.fused_attention_block(**inp, num_heads=e // d)
    torch.cuda.synchronize()
    dt = str(dtype).removeprefix("torch.")
    counted = {key: da.launches_by_dtype.get((key, d, dt), 0) - before.get((key, d, dt), 0)
               for key in ("dropout_attention_fwd", "dropout_attention_bwd", "fused_attention",
                           "attention_block")}
    wide = (lambda t: t) if f32 else (lambda t: t.float())
    qf, kf, vf, gf = (wide(t) for t in (q, k, v, g))
    pairs = {"fwd": (out, da.dropout_attention_reference(qf, kf, vf, seeds, RATE)),
             **dict(zip(("dq", "dk", "dv"), zip(grads, da.dropout_attention_backward_reference(
                 qf, kf, vf, gf, seeds, RATE)))),
             "fused": (fused, da.fused_attention_reference(wide(fq), wide(fk), wide(fv))),
             "block": (block, ab.fused_attention_block_reference(
                 **{x: wide(y) for x, y in inp.items()}, num_heads=e // d))}
    errs, tols = {}, {}
    for key, (got, ref) in pairs.items():
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{dt} {key} at head dim {d}, n {n}: shape {tuple(got.shape)} "
                                 f"against {tuple(ref.shape)}, or not finite")
        errs[key] = (got.float() - ref).abs().max().item()
        big = max(1.0, ref.abs().max().item())
        tols[key] = (F32_TOL * big if f32 else
                     KERNEL_ATOL if key == "block" else
                     DROPOUT_ATOL * (big if key in ("dq", "dk", "dv") else 1.0))
    mask_flips = int((kernel_keep_mask(torch, da, seeds, b, n, h, d, dtype=dtype)
                      != da.hash_keep_mask(seeds, n, RATE)).sum().item())
    repeat = all(torch.equal(x, y) for x, y in zip(grads, again))
    counted["dropout_attention_bwd"] -= 1  # the repeat
    row = dict(d=d, padded_to=da.padded_head_dim(d), n=n, dtype=dt, dropout_shape=[b, n, h, d],
               fused_shape=[bb, n, h, d], block_shape=[bb, n, e], errs=errs, tols=tols,
               mask_flips=mask_flips, bwd_repeat_identical=repeat, launches=counted)
    log(f"[{'float32' if f32 else 'kernel'}] head dim {d} (run at {row['padded_to']}), n {n}: "
        f"dropout ({b}, {n}, {h}, {d}), fused_attention ({bb}, {n}, "
        f"{h}, {d}), block ({bb}, {n}, {e}): max_abs_err " + ", ".join(
            f"{key} {errs[key]:.3e} (tol {tols[key]:.1e})" for key in errs)
        + f"; keep mask {mask_flips} of {b * h * n * n} bits differ; backward bit-identical on "
        f"a second call {repeat}; launches {counted}")
    if (mask_flips or not repeat or any(errs[key] > tols[key] for key in errs)
            or min(counted.values()) < 1):
        raise AssertionError(f"the {dt} kernels disagree at padded head dim {d}, n {n}: {row}")
    return row


def _padded_block_check(torch, b, n, e, heads, dtype) -> dict:
    """The block at width E (not a multiple of 64, or past 4096) against
    its plain version in `dtype`."""
    from maskbit_tpu_torch.nn import attention_block as ab

    f32 = dtype is torch.float32
    inp = _block_inputs(torch, b, n, e, seed=e + n, vectors=torch.float32 if f32 else
                        torch.bfloat16, dtype=dtype)
    before = ab.launches
    got = ab.fused_attention_block(**inp, num_heads=heads)
    torch.cuda.synchronize()
    wide = (lambda t: t) if f32 else (lambda t: t.float())
    ref = ab.fused_attention_block_reference(**{x: wide(y) for x, y in inp.items()},
                                             num_heads=heads)
    err = (got.float() - ref).abs().max().item()
    tol = F32_TOL * max(1.0, ref.abs().max().item()) if f32 else KERNEL_ATOL
    row = dict(block_shape=[b, n, e], heads=heads, d=e // heads,
               dtype=str(dtype).removeprefix("torch."), err=err, tol=tol,
               launches=ab.launches - before)
    log(f"[{'float32' if f32 else 'kernel'}] block ({b}, {n}, {e}) over {heads} heads of "
        f"{e // heads}: max_abs_err {err:.3e} (tol {tol:.1e})")
    if (got.shape != ref.shape or not bool(torch.isfinite(got).all()) or err > tol
            or row["launches"] != 1):
        raise AssertionError(f"the {row['dtype']} block disagrees at E = {e}: {row}")
    return row


def _model_node(path: str) -> dict:
    """A config's `model` node (plain YAML, no interpolation)."""
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)["model"]


def _flagship() -> dict:
    """The flagship config's `model` node."""
    return _model_node(CONFIG)


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
            "serve.device=cuda", "serve.shard_local_devices=false",  # one card on any host
            "experiment.vqgan_checkpoint=", "experiment.generator_checkpoint="]
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


def phase_train_check(torch, dtype=None, tol=None) -> dict:
    """One MLM train step of the flagship-width LFQBert (depth 2) with the
    kernels in `dtype` (default bf16) on the card against the same step with
    the plain versions in float32 on the CPU: the loss and the global grad
    norm within `tol` (relative; default bf16's)."""
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

    # bf16 keeps 8 significant bits: a few roundings per layer keep the loss
    # within ~1e-3 and the grad norm (a sum of squares over every parameter)
    # within a few 1e-3 of the f32 step; the tolerances leave room.
    dtype = dtype or torch.bfloat16
    tol = tol or {"mlm_loss": 1e-2, "grad_norm": 5e-2}
    cpu = build_module(lambda: LFQBert.from_config(mlm, vq), "cpu")
    init_generator_weights_(cpu, torch.Generator().manual_seed(1))
    card = build_module(lambda: LFQBert.from_config(mlm, vq, dtype=dtype), "cuda")
    card.load_state_dict(cpu.state_dict(), strict=True)
    results = {}
    before = dict(da.launches_by_dtype)
    for name, gen, dev in (("card", card, "cuda"), ("cpu", cpu, "cpu")):
        opt = make_optimizer(gen.parameters(), lambda t: 1e-4, beta2=0.96, weight_decay=0.045)
        train_step = make_generator_train_step_from_tokens(
            gen, vq["codebook_size"], MLMLossConfig(), class_label_dropout=0.1,
            ema_kwargs={"decay": 0.9999})
        _, metrics = train_step(init_generator_train_state(gen, opt),
                                torch.from_numpy(tokens).to(dev), torch.from_numpy(labels).to(dev),
                                injected=injected)
        results[name] = {k: float(metrics[k]) for k in ("mlm_loss", "grad_norm")}
    by_dtype = {f"{k}@{d}/{t}": n - before.get((k, d, t), 0)
                for (k, d, t), n in da.launches_by_dtype.items() if n != before.get((k, d, t), 0)}
    rel = {k: abs(results["card"][k] - results["cpu"][k]) / abs(results["cpu"][k])
           for k in ("mlm_loss", "grad_norm")}
    dt_name = str(dtype).removeprefix("torch.")
    log(f"[train-check] flagship width, depth {depth}, batch {b}: loss card({dt_name} kernels) "
        f"{results['card']['mlm_loss']:.6f} vs cpu(f32 plain) {results['cpu']['mlm_loss']:.6f} "
        f"(rel {rel['mlm_loss']:.2e}, tol {tol['mlm_loss']:g}); grad norm "
        f"{results['card']['grad_norm']:.6f} vs {results['cpu']['grad_norm']:.6f} (rel "
        f"{rel['grad_norm']:.2e}, tol {tol['grad_norm']:g}); kernel launches {by_dtype}")
    want = {f"dropout_attention_{x}@64/{dt_name}": depth for x in ("fwd", "bwd")}
    if by_dtype != want or rel["mlm_loss"] > tol["mlm_loss"] or rel["grad_norm"] > tol["grad_norm"]:
        raise AssertionError(f"train step disagrees: {results}, launches {by_dtype} != {want}")
    return {"results": results, "rel": rel, "launches": by_dtype}


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
    launched = {"attention_block": ab.launches, **da.launches}
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
        depth, steps = EVAL_DEPTH, int(mlm["num_steps"])
        argv = [f"config={CONFIG}", f"eval.total_samples={EVAL_SAMPLES}",
                f"eval.batch_size={EVAL_BATCH}", f"eval.stats_path={stats}",
                f"eval.device={device}", "eval.shard_local_devices=false",  # one card
                f"model.mlm_model.depth={depth}",
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


def _bert_model() -> dict:
    """The 12-bit generator config's `model` node with `model_cls: bert`."""
    import yaml

    with open(BERT_CONFIG) as f:
        model = yaml.safe_load(f)["model"]
    model["mlm_model"]["model_cls"] = "bert"
    return model


def _bert_logits_check(torch) -> dict:
    """Bert at the 12-bit config's width, depth cut to 2: bf16 on the card
    (the attention block kernel) against float32 plain on the CPU."""
    from maskbit_tpu_torch.cli.common import build_module, random_init_
    from maskbit_tpu_torch.models.generator import make_generator
    from maskbit_tpu_torch.nn import attention_block as ab

    model = _bert_model()
    mlm, vq = dict(model["mlm_model"], depth=2), model["vq_model"]
    card = build_module(lambda: make_generator("bert", mlm, vq, dtype=torch.bfloat16), "cuda")
    random_init_(card, torch.Generator(device="cuda").manual_seed(11))
    cpu = build_module(lambda: make_generator("bert", dict(mlm, attention_impl="einsum"), vq),
                       "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()}, strict=True)
    card.to(torch.bfloat16)
    g = torch.Generator().manual_seed(12)
    b = 4
    tokens = torch.randint(0, card.mask_token + 1, (b, card.seq_len, card.codebook_splits),
                           generator=g, dtype=torch.int32)
    labels = torch.randint(0, 1000, (b,), generator=g)
    drop = torch.tensor([False, True, False, True])
    before = ab.launches
    with torch.inference_mode():
        got = card(tokens.cuda(), labels.cuda(), drop.cuda()).float().cpu()
        ref = cpu(tokens, labels, drop)
    launched = ab.launches - before
    rel = ((got - ref).norm() / ref.norm()).item()
    log(f"[variants] Bert logits (depth 2, bf16 block kernel on the card vs f32 plain on the "
        f"CPU): shape {tuple(got.shape)}, relative error {rel:.3e} (tol 3e-2, as LFQBert's), "
        f"max|ref| {ref.abs().max().item():.3f}; block launches {launched}")
    if not torch.isfinite(got).all() or rel > 3e-2 or launched != 2:
        raise AssertionError(f"Bert logits disagree: relative error {rel}, launches {launched}")
    return {"relative_error": rel}


def _serve_12bit(torch, device_info, model_cls: str) -> dict:
    """`cli.serve` on the 12-bit config with the generator `model_cls` at
    serve batch 8."""
    from maskbit_tpu_torch.cli.serve import main
    from maskbit_tpu_torch.nn import attention_block as ab
    from maskbit_tpu_torch.nn import dropout_attention as da

    mlm = _bert_model()["mlm_model"]
    depth, steps = int(mlm["depth"]), int(mlm["num_steps"])
    argv = [f"config={BERT_CONFIG}", f"model.mlm_model.model_cls={model_cls}",
            f"serve.batch_size={SERVE_BATCH}",
            "serve.port=0", "serve.device=cuda", "serve.shard_local_devices=false",
            "experiment.vqgan_checkpoint=", "experiment.generator_checkpoint="]
    ab.launches = 0
    for key in da.launches:
        da.launches[key] = 0
    t0 = time.perf_counter()
    server, service = main(argv, serve_forever=False)
    startup = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    labels = [1, 7, 282, 88, 207, 360, 387, 974][:SERVE_BATCH]
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        times, outputs = [], []
        for _ in range(3):
            data, dt = _post(base, {"labels": labels, "seed": 5})
            outputs.append(data)
            times.append(dt)
        imgs = _images(outputs[0])
        _check_images(imgs, len(labels))
        if any(o != outputs[0] for o in outputs):
            raise AssertionError(f"seeded {model_cls} repeats differ")
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    torch.cuda.synchronize()
    launches = {"attention_block": ab.launches, **da.launches}
    expected = depth * steps * service.device_calls
    request_s = statistics.median(times)
    log(f"[variants] {model_cls} serve: startup {startup:.2f} s; {len(times)} seeded requests of "
        f"{len(labels)} labels {', '.join(f'{t:.3f}' for t in times)} s (byte-identical); "
        f"median {request_s:.3f} s = {len(labels) / request_s:.3f} img/s at serve batch "
        f"{SERVE_BATCH} [{device_info['card']}]")
    log(f"[variants] {model_cls} serve launches {launches}; expected depth {depth} x steps {steps} x "
        f"device calls {service.device_calls} = {expected} of the block and fused_attention, "
        f"0 of the dropout kernels")
    want = {"attention_block": expected, "fused_attention": expected,
            "dropout_attention_fwd": 0, "dropout_attention_bwd": 0}
    if launches != want:
        raise AssertionError(f"{model_cls} serve launched {launches}, expected {want}")
    return {"launches": launches, "request_s": times, "img_per_s": len(labels) / request_s,
            "startup_s": startup}


def _train_12bit(torch, device_info, out_dir, model_cls: str) -> dict:
    """`cli.train_maskbit` on the 12-bit config with the generator
    `model_cls`: 6 steps at batch 32."""
    from maskbit_tpu_torch.cli.train_maskbit import main
    from maskbit_tpu_torch.nn import attention_block as ab
    from maskbit_tpu_torch.nn import dropout_attention as da

    depth = int(_bert_model()["mlm_model"]["depth"])
    argv = [f"config={BERT_CONFIG}", f"model.mlm_model.model_cls={model_cls}",
            f"training.per_device_batch_size={TRAIN_BATCH}",
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
    launched = {"attention_block": ab.launches, **da.launches}
    hist = result["history"]
    losses = [h["mlm_loss"] for h in hist]
    step_s = [h["perf/step_seconds"] for h in hist]
    median_s = statistics.median(step_s[1:])
    log(f"[variants] {model_cls} train: {len(hist)} steps at batch {TRAIN_BATCH}, depth {depth}: "
        f"losses {', '.join(f'{x:.4f}' for x in losses)}; median step (steps 2..{len(hist)}) "
        f"{median_s * 1e3:.1f} ms = {TRAIN_BATCH / median_s:.1f} samples/s; peak memory "
        f"{peak_gib:.2f} GiB; wall {wall:.1f} s [{device_info['card']}]")
    log(f"[variants] {model_cls} train launches {launched} (expected {depth * TRAIN_STEPS} of each "
        f"dropout kernel)")
    if len(losses) != TRAIN_STEPS or not all(x == x and abs(x) < float("inf") for x in losses):
        raise AssertionError(f"non-finite or missing {model_cls} losses: {losses}")
    for key in ("dropout_attention_fwd", "dropout_attention_bwd"):
        if launched[key] != depth * TRAIN_STEPS:
            raise AssertionError(f"{model_cls} train: {key} launched {launched[key]} times")
    return {"launches": launched, "losses": losses, "step_seconds": step_s,
            "median_step_s": median_s, "samples_per_s": TRAIN_BATCH / median_s,
            "peak_gib": peak_gib}


def _convert_round_trip(torch, work, bert_bin) -> dict:
    """`cli.convert_checkpoint` .bin -> .msgpack -> .bin for the full-width
    Bert and the 14-bit LFQ tokenizer, bit for bit; the converted Bert's
    logits on the card against the original's."""
    from maskbit_tpu_torch.cli import convert_checkpoint
    from maskbit_tpu_torch.cli.common import build_module, random_init_
    from maskbit_tpu_torch.core.checkpoint import load_pretrained, save_pretrained
    from maskbit_tpu_torch.core.config import load_config
    from maskbit_tpu_torch.models.generator import make_generator
    from maskbit_tpu_torch.models.tokenizer import ConvVQModel

    vq14 = load_config(TOKENIZER_CONFIGS[0]).model.vq_model
    tok_bin = os.path.join(work, "tokenizer_14bit.bin")
    tokenizer = build_module(lambda: ConvVQModel.from_config(vq14), "cpu")
    random_init_(tokenizer, torch.Generator().manual_seed(13))
    save_pretrained(tokenizer, tok_bin)
    del tokenizer
    out = {}
    for name, source, flags in (("bert", bert_bin, []),
                                ("tokenizer_14bit", tok_bin,
                                 ["--codebook-size", str(vq14.codebook_size)])):
        zoo, back = (os.path.join(work, f"{name}{ext}") for ext in (".msgpack", "-back.bin"))
        t0 = time.perf_counter()
        convert_checkpoint.main(["--input", source, "--output", zoo])
        t1 = time.perf_counter()
        convert_checkpoint.main(["--input", zoo, "--output", back] + flags)
        t2 = time.perf_counter()
        a, b = (torch.load(p, map_location="cpu", weights_only=True) for p in (source, back))
        diff = sorted(set(a) ^ set(b)) + [k for k in a if k in b and not (
            a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and torch.equal(a[k], b[k]))]
        sizes = {p: os.path.getsize(p) for p in (source, zoo, back)}
        out[name] = {"to_msgpack_s": t1 - t0, "to_bin_s": t2 - t1, "keys": len(a),
                     "bytes": {os.path.basename(p): v for p, v in sizes.items()}}
        log(f"[variants] convert {name}: .bin -> .msgpack {t1 - t0:.2f} s, .msgpack -> .bin "
            f"{t2 - t1:.2f} s; sizes " + ", ".join(f"{os.path.basename(p)} {v / 2**20:.1f} MiB"
                                                   for p, v in sizes.items())
            + f"; {len(a)} keys, {len(diff)} differ")
        if diff:
            raise AssertionError(f"convert {name}: keys differ after the round trip: {diff[:5]}")

    model = _bert_model()
    originals = []
    for path in (bert_bin, os.path.join(work, "bert-back.bin")):
        gen = build_module(lambda: make_generator("bert", model["mlm_model"], model["vq_model"],
                                                  dtype=torch.bfloat16), "cuda")
        gen.load_state_dict(load_pretrained(path, "cuda"), strict=True)
        originals.append(gen)
    g = torch.Generator(device="cuda").manual_seed(14)
    tokens = torch.randint(0, originals[0].mask_token + 1, (2, originals[0].seq_len, 2),
                           generator=g, device="cuda", dtype=torch.int32)
    labels = torch.tensor([5, 6], device="cuda")
    with torch.inference_mode():
        want, got = (m(tokens, labels) for m in originals)
    equal = bool(torch.equal(want, got))
    log(f"[variants] converted Bert on the card: logits {tuple(got.shape)} equal bit for bit "
        f"to the original's: {equal}")
    if not equal:
        raise AssertionError("the converted Bert's logits differ from the original's")
    return out


def _taming(torch, device_info, work) -> dict:
    """`cli.eval_tokenizer` on the taming config at its published widths,
    then one float32 forward on the card (TF32 off) against the CPU."""
    import numpy as np

    from maskbit_tpu_torch.cli import eval_tokenizer
    from maskbit_tpu_torch.cli.common import build_module, random_init_
    from maskbit_tpu_torch.core.config import load_config
    from maskbit_tpu_torch.models.taming import OriginalVQModel
    from maskbit_tpu_torch.utils.precision import full_f32

    pattern = os.path.join(work, "shards", "img-%04d.tar")
    os.makedirs(os.path.dirname(pattern))
    _write_image_shards(pattern, TAMING_BATCHES * 16, 256)
    shards = os.path.join(work, "shards", "img-0000.tar")
    # the metrics that need no Inception, ADM-graph or VGG16 weights
    env = {"MASKBIT_EVAL_MAX_BATCHES": str(TAMING_BATCHES), "MASKBIT_INCEPTION_WEIGHTS": "",
           "MASKBIT_ADM_PB": "", "MASKBIT_VGG16_WEIGHTS": ""}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        metrics = eval_tokenizer.main([
            f"config={TAMING_CONFIG}", "eval.device=cuda", "experiment.vqgan_checkpoint=",
            f"dataset.params.train_shards_path_or_url={shards}",
            f"dataset.params.eval_shards_path_or_url={shards}",
            f"experiment.output_dir={os.path.join(work, 'eval_taming')}"])
        wall = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if len(metrics) != 6 or not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"eval_tokenizer taming: {metrics}")

    vq = load_config(TAMING_CONFIG).model.vq_model
    card = build_module(lambda: OriginalVQModel.from_config(vq, dtype=torch.bfloat16), "cuda")
    random_init_(card, torch.Generator(device="cuda").manual_seed(15))
    images = torch.from_numpy(np.random.default_rng(16).uniform(
        size=(16, 256, 256, 3)).astype(np.float32)).cuda()
    with torch.inference_mode():
        forward_ms = _time_ms(torch, lambda: card(images), iters=5, warmup=2)
    log(f"[variants] eval_tokenizer taming (bf16, ch 128, ch_mult (1, 1, 2, 2, 4), attention at "
        f"16, z 256, codebook 1024 x 256): {TAMING_BATCHES} batches of 16 in {wall:.1f} s "
        f"(model build, random init and shard reading included) = "
        f"{TAMING_BATCHES * 16 / wall:.2f} img/s; one forward of 16 images {forward_ms:.1f} ms = "
        f"{16e3 / forward_ms:.1f} img/s [{device_info['card']}]; {metrics}")

    # float32, TF32 off on the card, against the CPU
    card = build_module(lambda: OriginalVQModel.from_config(vq), "cuda")
    random_init_(card, torch.Generator(device="cuda").manual_seed(15))
    cpu = build_module(lambda: OriginalVQModel.from_config(vq), "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()}, strict=True)
    x = images[:1].cpu()
    with torch.inference_mode(), full_f32():
        want, want_result = cpu(x)
        got, got_result = card(x.cuda())
        tokens = want_result["min_encoding_indices"].reshape(1, -1)
        decoded_cpu = cpu.decode_tokens(tokens)
        decoded_card = card.decode_tokens(tokens.cuda())
    agree = (got_result["min_encoding_indices"].cpu() == want_result["min_encoding_indices"])
    agree = agree.float().mean().item()
    scale = decoded_cpu.abs().max().item()
    decode_gap = (decoded_card.cpu() - decoded_cpu).abs().max().item() / scale
    recon_gap = (got.cpu() - want).abs().max().item() / scale
    log(f"[variants] taming float32 forward, card (TF32 off) vs CPU, one 256 px image: tokens "
        f"equal {agree:.4%}; decode of the CPU's tokens max |diff| / max|cpu| {decode_gap:.3e} "
        f"(tol 1e-4, tokens all equal); reconstruction {recon_gap:.3e}")
    if agree != 1.0 or decode_gap > 1e-4 or not torch.isfinite(got).all():
        raise AssertionError(f"taming card vs CPU: tokens {agree}, decode gap {decode_gap}")
    return {"metrics": metrics, "wall_s": wall, "img_per_s": TAMING_BATCHES * 16 / wall,
            "forward_ms": forward_ms, "token_agreement": agree, "decode_gap": decode_gap,
            "recon_gap": recon_gap}


def phase_variants(torch, device_info) -> dict:
    """Bert served and trained through the kernels, the converter's round
    trip, and the taming tokenizer (phase 10)."""
    work = os.path.join(ROOT, "build", "chip_smoke_data")  # git-ignored
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    try:
        check = _bert_logits_check(torch)
        # LFQBert at the same widths, for comparison, within the same call
        lfq_serve = _serve_12bit(torch, device_info, "lfq_bert")
        serve = _serve_12bit(torch, device_info, "bert")
        train = _train_12bit(torch, device_info, os.path.join(work, "bert_train"), "bert")
        convert = _convert_round_trip(
            torch, work, os.path.join(work, "bert_train", f"model-{TRAIN_STEPS}.bin"))
        shutil.rmtree(os.path.join(work, "bert_train"))
        lfq_train = _train_12bit(torch, device_info, os.path.join(work, "lfq_train"), "lfq_bert")
        shutil.rmtree(os.path.join(work, "lfq_train"))
        taming = _taming(torch, device_info, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[variants] 12-bit widths, Bert vs LFQBert: serve {serve['img_per_s']:.3f} vs "
        f"{lfq_serve['img_per_s']:.3f} img/s; train {train['samples_per_s']:.1f} vs "
        f"{lfq_train['samples_per_s']:.1f} samples/s, peak {train['peak_gib']:.2f} vs "
        f"{lfq_train['peak_gib']:.2f} GiB [{device_info['card']}]")
    log(f"[variants] phase time {time.perf_counter() - t0:.1f} s")
    return {"logits_check": check, "serve": serve, "train": train, "convert": convert,
            "taming": taming, "lfq_bert_serve": lfq_serve, "lfq_bert_train": lfq_train}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_ranks(spec: dict, world: int, env: dict = None) -> list:
    """`world` processes of this script in `--worker` mode, joined as one
    torch.distributed group (torchrun's variables set by hand); each logs
    to chiprun_out/chip_smoke/distributed_<tag>_rank<r>.log."""
    base = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                **(env or {}))
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = []
    for rank in range(world):
        with open(os.path.join(OUT_DIR, f"distributed_{spec['tag']}_rank{rank}.log"), "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker", json.dumps(spec)],
                cwd=ROOT, env=dict(base, RANK=str(rank), LOCAL_RANK=str(rank)), stdout=f,
                stderr=subprocess.STDOUT))
    return procs


def _wait_ranks(procs: list, tag: str, timeout: float) -> None:
    """Every rank exits 0 within `timeout` seconds; otherwise, as soon as
    one rank fails or the time is up, every rank is killed (the others
    would wait in a collective until NCCL's own timeout) and the run fails
    with the end of the first failing log."""
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.time() > deadline:
                raise AssertionError(f"[distributed] {tag}: ranks still running after {timeout} s")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(OUT_DIR, f"distributed_{tag}_rank{rank}.log")) as f:
                tail = f.read()[-4000:]
            raise AssertionError(f"[distributed] {tag} rank {rank} exited {p.returncode}:\n{tail}")


def _rank_results(work: str, tag: str, world: int) -> list:
    out = []
    for rank in range(world):
        with open(os.path.join(work, f"{tag}_rank{rank}.json")) as f:
            out.append(json.load(f))
    return out


def _rank_write(spec: dict, rank: int, result: dict) -> None:
    with open(os.path.join(spec["work"], f"{spec['tag']}_rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _sync(torch, device) -> float:
    """The host clock once `device`'s work, NCCL's streams included, is done."""
    if str(device).startswith("cuda"):
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _timed_all_reduce(torch, device, seconds: list, captured: list = None):
    """Wrap `ShardedParams.reduce_scatter_grads` (the trainers' gradient reduction)
    so each call's time (the card synchronised on both sides) is kept apart
    from the rest of the step; with `captured`, a host copy of the reduced
    gradients too, gathered whole from the slices when the store is split
    (a collective every rank makes at the same point). Returns the function
    it wrapped, for the caller to put back."""
    from maskbit_tpu_torch.parallel import zero

    real = zero.ShardedParams.reduce_scatter_grads

    def timed(self, names, grads):
        t0 = _sync(torch, device)
        out = real(self, names, grads)
        seconds.append(_sync(torch, device) - t0)
        if captured is not None:
            whole = self.whole(names, out)
            captured.extend(t.detach().float().cpu().clone() for t in whole)
        return out

    zero.ShardedParams.reduce_scatter_grads = timed
    return real


def _rank_train_cli(torch, spec) -> None:
    """One rank of `cli/train_maskbit.main`, its dropout-kernel launches
    counted from 0 just before and read just after."""
    import torch.distributed as dist

    from maskbit_tpu_torch.cli import train_maskbit
    from maskbit_tpu_torch.nn import dropout_attention as da
    from maskbit_tpu_torch.parallel.mesh import process_count, process_index

    reduce_s = []
    _timed_all_reduce(torch, spec["device"], reduce_s)
    for key in da.launches:
        da.launches[key] = 0
    result = train_maskbit.main(spec["argv"])
    hist = result["history"]
    cuda = spec["device"] == "cuda"
    _rank_write(spec, process_index(), {
        "world": process_count(), "backend": dist.get_backend(), "steps": result["steps"],
        "resumed_from": result["resumed_from"], "launches": dict(da.launches),
        "losses": [h["mlm_loss"] for h in hist], "step_s": [h["perf/step_seconds"] for h in hist],
        "all_reduce_s": reduce_s, "save_s": result["save_seconds"],
        "card": torch.cuda.current_device() if cuda else None,
        "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None})


def _grad_step_inputs(torch, spec):
    """The flagship-width LFQBert of the gradient check (hidden dropout off,
    attention dropout through the kernels), its seeded weights and one step's
    global-batch tokens, labels and injected draws."""
    import numpy as np

    from maskbit_tpu_torch.cli.common import build_module
    from maskbit_tpu_torch.models.generator import LFQBert, init_generator_weights_

    model_cfg = _model_node(spec["gen_config"])
    mlm = dict(model_cfg["mlm_model"], depth=spec["grad_depth"], dropout=0.0,
               attention_dropout=RATE)
    vq = model_cfg["vq_model"]
    dtype = torch.bfloat16 if spec["device"] == "cuda" else torch.float32
    model = build_module(lambda: LFQBert.from_config(mlm, vq, dtype=dtype), spec["device"])
    init_generator_weights_(model, torch.Generator(device=spec["device"]).manual_seed(1))
    b, seq, depth = spec["global_batch"], model.seq_len, mlm["depth"]
    rng = np.random.default_rng(0)
    data = {"tokens": rng.integers(0, vq["codebook_size"], size=(b, seq)).astype(np.int64),
            "labels": rng.integers(0, 1000, size=(b,)).astype(np.int64),
            "injected": {"mask_ratio_uniform": rng.random(b, dtype=np.float32),
                         "mask_token_uniform": rng.random((b, seq, mlm["codebook_splits"]),
                                                          dtype=np.float32),
                         "label_drop_uniform": rng.random(b, dtype=np.float32),
                         "attention_seeds": [rng.integers(0, 2**32, size=(b, mlm["heads"]),
                                                          dtype=np.int64)
                                             for _ in range(depth)]}}
    return model, vq, data


def _grad_step(torch, spec, model, vq, data, captured, reduce_s):
    """One step of `make_generator_train_step_from_tokens` on this process's
    rows; returns the updated parameters on the host."""
    from maskbit_tpu_torch.losses.mlm import MLMLossConfig
    from maskbit_tpu_torch.parallel import zero
    from maskbit_tpu_torch.parallel.mesh import local_rows, process_count
    from maskbit_tpu_torch.train.generator_trainer import (
        init_generator_train_state,
        make_generator_train_step_from_tokens,
    )
    from maskbit_tpu_torch.train.optim import make_optimizer

    real = _timed_all_reduce(torch, spec["device"], reduce_s, captured)
    opt = make_optimizer(model.parameters(), lambda t: 1e-4, beta2=0.96, weight_decay=0.045)
    step = make_generator_train_step_from_tokens(model, vq["codebook_size"], MLMLossConfig(),
                                                 class_label_dropout=0.1,
                                                 ema_kwargs={"decay": 0.9999})
    local = data["tokens"].shape[0] // process_count()
    tokens = torch.from_numpy(local_rows(data["tokens"], local)).to(spec["device"])
    labels = torch.from_numpy(local_rows(data["labels"], local)).to(spec["device"])
    try:
        state, metrics = step(init_generator_train_state(model, opt), tokens, labels,
                              injected=data["injected"])
    finally:
        zero.ShardedParams.reduce_scatter_grads = real
    metrics["state_bytes"] = _state_bytes(state)
    return {n: p.detach().float().cpu().clone() for n, p in model.named_parameters()}, metrics


def _resident_bytes(tensors) -> int:
    """The bytes of the storages behind `tensors`, each storage once."""
    storages = {}
    for t in tensors:
        st = t.untyped_storage()
        storages[st.data_ptr()] = st.nbytes()
    return sum(storages.values())


def _state_bytes(state) -> int:
    """The bytes this rank keeps of a Stage-II train state between steps:
    the module's parameters (under a sharded store, empty where split), the
    store's slices, the AdamW moments and the EMA shadows."""
    return _resident_bytes(
        list(state.model.parameters()) + list(state.store.shards.values()) + state.opt.mu
        + state.opt.nu + (list(state.ema.params.values()) if state.ema is not None else []))


def _timed_collectives(torch, device, seconds: dict):
    """Wrap the collectives of `parallel/mesh.py` where `parallel/zero.py` and
    the Megatron layers call them, so each call's time (the card
    synchronised on both sides) adds to `seconds` under its kind:
    all_gather, reduce_scatter, tensor_all_reduce (over the tensor group)
    or all_reduce (over any other group). Returns a function that puts the
    originals back."""
    from maskbit_tpu_torch.parallel import mesh as pm
    from maskbit_tpu_torch.parallel import zero

    tensor_ranks = pm.group("tensor").ranks

    def timed(fn, kind_of):
        def wrapper(x, g=None):
            if pm._size(g) == 1:
                return fn(x, g)
            t0 = _sync(torch, device)
            out = fn(x, g)
            kind = kind_of(g)
            seconds[kind] = seconds.get(kind, 0.0) + _sync(torch, device) - t0
            return out
        return wrapper

    reduce_kind = lambda g: ("tensor_all_reduce" if g is not None  # noqa: E731
                             and g.ranks == tensor_ranks else "all_reduce")
    real = {(pm, "_all_reduce_sum_"): (pm._all_reduce_sum_, reduce_kind),
            (zero, "_all_reduce_sum_"): (zero._all_reduce_sum_, reduce_kind),
            (zero, "all_gather_flat"): (zero.all_gather_flat, lambda g: "all_gather"),
            (zero, "reduce_scatter_flat"): (zero.reduce_scatter_flat, lambda g: "reduce_scatter")}
    for (module, name), (fn, kind_of) in real.items():
        setattr(module, name, timed(fn, kind_of))

    def restore():
        for (module, name), (fn, _) in real.items():
            setattr(module, name, fn)
    return restore


def _digest(tensors) -> list:
    """float64 sums of each tensor and of its square: equal bits on two
    ranks that hold equal tensors."""
    return [v for t in tensors for v in (t.double().sum().item(), t.double().pow(2).sum().item())]


def _rank_combined(torch, spec) -> None:
    """b, d and e of phase 11 in one pair of ranks (one start-up)."""
    from maskbit_tpu_torch.cli import eval_maskbit, train_tokenizer
    from maskbit_tpu_torch.cli.common import synthetic_batches
    from maskbit_tpu_torch.core.config import config_from_cli
    from maskbit_tpu_torch.nn import attention_block as ab
    from maskbit_tpu_torch.nn import dropout_attention as da
    from maskbit_tpu_torch.parallel.mesh import (
        maybe_init_distributed,
        process_allgather_f64,
        process_index,
    )

    device = maybe_init_distributed(torch.device(spec["device"]))
    rank = process_index()
    out = {}
    # b. the reduced gradients of one step with injected global draws
    model, vq, data = _grad_step_inputs(torch, spec)
    captured, reduce_s = [], []
    if str(device).startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    t0 = _sync(torch, device)
    params, metrics = _grad_step(torch, spec, model, vq, data, captured, reduce_s)
    out["grad_step_s"] = _sync(torch, device) - t0
    out["state_bytes"] = metrics.pop("state_bytes")
    out["peak_bytes"] = (torch.cuda.max_memory_allocated() if str(device).startswith("cuda")
                         else None)
    out["grad_all_reduce_s"] = reduce_s
    out["grad_loss"] = float(metrics["mlm_loss"])
    agree = process_allgather_f64(_digest(list(params.values()) + captured))
    out["grad_ranks_agree"] = bool((agree == agree[0]).all())
    if rank == 0:
        torch.save({"grads": captured, "params": params},
                   os.path.join(spec["work"], "dp_grads.pt"))
    del model, params, captured
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()

    # d. Stage I across the discriminator's gate
    logger = train_tokenizer._logger()
    run = train_tokenizer.build_training(config_from_cli(spec["tok_argv"]), logger)
    state, step = run["state"], run["train_step"]
    batches = synthetic_batches(spec["tok_batch"], spec["tok_res"], seed=rank)
    tok = {"agree": [], "lecam": [], "step_s": [], "total_loss": [], "d_factor": []}
    for _ in range(spec["tok_steps"]):
        images = torch.from_numpy(next(batches)["image"]).to(device)
        t0 = _sync(torch, device)
        state, m = step(state, images)
        tok["step_s"].append(_sync(torch, device) - t0)
        tensors = (list(run["model"].parameters()) + list(run["discriminator"].parameters())
                   + list(state.ema.params.values()) + list(state.lecam))
        gathered = process_allgather_f64(_digest(tensors))
        tok["agree"].append(bool((gathered == gathered[0]).all()))
        tok["lecam"].append([t.item() for t in state.lecam])
        tok["total_loss"].append(float(m["total_loss"]))
        tok["d_factor"].append(float(m["discriminator_factor"]))
    out["tokenizer"] = tok
    del run, state, step
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()

    # e. eval_maskbit, its samples split over the ranks
    feats, logits = [], []
    real_make = eval_maskbit.make_inception_fn

    def make_inception_fn(dev):
        fn = real_make(dev)

        def recording(images):
            result = fn(images)
            feats.append(result["2048"].double().cpu())
            logits.append(result["logits_unbiased"].double().cpu())
            return result

        return recording

    eval_maskbit.make_inception_fn = make_inception_fn
    for key in da.launches:
        da.launches[key] = 0
    ab.launches = 0
    t0 = time.perf_counter()
    gen = eval_maskbit.main(spec["eval_argv"])
    out["eval_s"] = time.perf_counter() - t0
    out["eval_launches"] = {"attention_block": ab.launches,
                            "fused_attention": da.launches["fused_attention"]}
    out["eval_count"] = gen["count"]
    out["eval_local_samples"] = gen["local_samples"]
    acc = gen["accumulator"]
    torch.save({"features": torch.cat(feats)[:gen["local_samples"]].numpy(),
                "logits": torch.cat(logits)[:gen["local_samples"]].numpy(),
                "act_sum": acc.act_sum, "act_outer": acc.act_outer,
                "results": gen["results"]},
               os.path.join(spec["work"], f"dp_eval_rank{rank}.pt"))
    out["backend"] = torch.distributed.get_backend()
    _rank_write(spec, rank, out)


def _rank_handshake(torch, spec) -> None:
    """Join the group and time `all_reduce_mean_` of one full gradient bucket
    (`parallel/mesh.BUCKET_BYTES` of float32) a few times: phase 15's first
    launch, short, so that a group that cannot form fails the phase early."""
    import torch.distributed as dist

    from maskbit_tpu_torch.parallel import mesh as pm

    device = pm.maybe_init_distributed(torch.device(spec["device"]))
    bucket = torch.ones(pm.BUCKET_BYTES // 4, device=device)
    seconds = []
    for _ in range(6):
        t0 = _sync(torch, device)
        pm.all_reduce_mean_([bucket])
        seconds.append(_sync(torch, device) - t0)
    _rank_write(spec, pm.process_index(), {
        "backend": dist.get_backend(), "card": str(device), "bucket_s": seconds,
        "mean_ok": bool((bucket == 1).all())})


def _rank_main(spec: dict) -> int:
    """A rank process of phase 11 (`chip_smoke.py --worker SPEC`)."""
    sys.path.insert(0, spec["tree"])
    import torch

    if spec["device"] == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    {"train_cli": _rank_train_cli, "combined": _rank_combined, "sharded": _rank_sharded,
     "handshake": _rank_handshake}[spec["task"]](torch, spec)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


def _logged_steps(path: str) -> list:
    if not os.path.exists(path):
        return []
    steps = []
    with open(path) as f:
        for line in f:
            try:
                steps.append(json.loads(line)["step"])
            except (ValueError, KeyError):
                continue  # a line cut mid-write
    return steps


def _check_grads(torch, ranks_file: str, grads_1, params_0, params_1) -> dict:
    """The two ranks' reduced gradients and updated parameters against the
    one-process step's: relative L2 gaps, the worst tensor's, and the share
    of parameters whose update has the same sign."""
    saved = torch.load(ranks_file, weights_only=False)
    g2, g1 = saved["grads"], grads_1
    if len(g2) != len(g1):
        raise AssertionError(f"{len(g2)} reduced gradients, {len(g1)} in one process")
    diff = sum(float((a - b).double().pow(2).sum()) for a, b in zip(g2, g1))
    ref = sum(float(b.double().pow(2).sum()) for b in g1)
    worst = max(float((a - b).norm() / b.norm().clamp(min=1e-30)) for a, b in zip(g2, g1))
    up_diff = up_ref = 0.0
    same_sign = total = 0
    for name, p1 in params_1.items():
        d1, d2 = p1 - params_0[name], saved["params"][name] - params_0[name]
        up_diff += float((d2 - d1).double().pow(2).sum())
        up_ref += float(d1.double().pow(2).sum())
        same_sign += int((torch.sign(d1) == torch.sign(d2)).sum())
        total += d1.numel()
    return {"grad_rel_l2": (diff / ref) ** 0.5, "grad_worst_tensor_rel_l2": worst,
            "update_rel_l2": (up_diff / up_ref) ** 0.5, "update_same_sign": same_sign / total}


def _token_shards(work: str, gen_config: str, n: int) -> str:
    """`n` random samples of the generator's tokens in shards of 256; their
    pattern."""
    import numpy as np

    from maskbit_tpu_torch.data.token_shards import TokenShardWriter

    mlm, vq = (_model_node(gen_config)[k] for k in ("mlm_model", "vq_model"))
    seq = (int(mlm.get("img_size", 256)) // int(mlm.get("input_stride", 16))) ** 2
    rng = np.random.default_rng(0)
    writer = TokenShardWriter(os.path.join(work, "tokens", "train-%04d.npz"), maxcount=256)
    writer.write_batch(rng.integers(0, vq["codebook_size"], size=(n, seq)),
                       rng.integers(0, 1000, size=(n,)))
    writer.close()
    return os.path.join(work, "tokens", "*.npz")


def _stop_and_resume(base: dict, common: list, world: int, batch: int, depth: int,
                     out_dir: str, timeout: float, cuda: bool, card: str, tag: str,
                     label: str) -> dict:
    """`world` ranks of `cli.train_maskbit` at `batch` a rank and `depth`;
    SIGTERM to the last rank once step SAVE_EVERY + 1 is logged: every rank
    stops on the same step, a multiple of DP_CHECK_EVERY, whose save is the
    newest committed step; then `world` ranks resume from it for one step.
    Per rank the dropout kernels' launches (depth x steps each)."""
    argv = common + [f"training.per_device_batch_size={batch}", f"model.mlm_model.depth={depth}",
                     f"experiment.save_every={SAVE_EVERY}", f"experiment.output_dir={out_dir}"]
    procs = _spawn_ranks(dict(base, task="train_cli", tag=f"{tag}_stop",
                              argv=argv + ["training.max_train_steps=100000"]), world)
    metrics = os.path.join(out_dir, "metrics.jsonl")
    try:
        deadline = time.time() + timeout
        while len(_logged_steps(metrics)) < SAVE_EVERY + 1:
            if any(p.poll() is not None for p in procs) or time.time() > deadline:
                break  # _wait_ranks reports it
            time.sleep(0.2)
        procs[-1].send_signal(signal.SIGTERM)
        t_signal = _logged_steps(metrics)
    finally:
        _wait_ranks(procs, f"{tag}_stop", timeout)
    first = _rank_results(base["work"], f"{tag}_stop", world)
    stopped = first[0]["steps"]
    committed = sorted(int(n) for n in os.listdir(os.path.join(out_dir, "checkpoints"))
                       if n.isdigit())
    for r in first:
        log(f"[{label}] rank of {r['world']} ({r['backend']}, card {r['card']}): stopped at step "
            f"{r['steps']} (SIGTERM to rank {world - 1} after step "
            f"{t_signal[-1] if t_signal else None}); launches {r['launches']}; median step "
            f"{statistics.median(r['step_s'][1:]):.3f} s; gradient all-reduce median "
            f"{statistics.median(r['all_reduce_s'][1:]):.3f} s of {len(r['all_reduce_s'])}; "
            f"peak {r['peak_bytes']} B; saves in the loop "
            f"{', '.join(f'{x:.2f}' for x in r['save_s'])} s [{card}]")
    if [r["steps"] for r in first] != [stopped] * world or stopped % DP_CHECK_EVERY:
        raise AssertionError(f"the ranks stopped at {[r['steps'] for r in first]}")
    if committed[-1] != stopped or not os.path.exists(os.path.join(out_dir,
                                                                   f"model-{stopped}.bin")):
        raise AssertionError(f"committed steps {committed}, stopped at {stopped}")
    for r in first:
        want = depth * stopped
        if cuda and (r["launches"]["dropout_attention_fwd"] != want
                     or r["launches"]["dropout_attention_bwd"] != want):
            raise AssertionError(f"launches {r['launches']}, expected {want} of each")
    procs = _spawn_ranks(dict(base, task="train_cli", tag=f"{tag}_resume",
                              argv=argv + [f"training.max_train_steps={stopped + 1}"]), world)
    _wait_ranks(procs, f"{tag}_resume", timeout)
    second = _rank_results(base["work"], f"{tag}_resume", world)
    log(f"[{label}] resume: {[(r['resumed_from'], r['steps']) for r in second]} "
        f"(resumed from, steps); losses {[r['losses'] for r in second]}")
    if any((r["resumed_from"], r["steps"]) != (stopped, stopped + 1) for r in second):
        raise AssertionError(f"resume: {second}")
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"stopped": stopped, "committed": committed, "ranks": first, "resume": second}


def _combined_spec(base: dict, work: str, gen_config: str, tok_config: str, device: str,
                   s: dict, world: int) -> dict:
    """The spec of `_rank_combined`'s ranks: the gradient check at
    `s["batch"]` a rank, Stage I at `s["tok_batch"]` across
    `s["tok_gate"]`, `eval_maskbit` on `s["eval_samples"]` at
    `s["eval_batch"]`."""
    return dict(base, task="combined", tag="combined", gen_config=gen_config,
                grad_depth=s["grad_depth"], global_batch=world * s["batch"],
                tok_batch=s["tok_batch"], tok_res=int(s.get("tok_res", 256)),
                tok_steps=s["tok_steps"],
                tok_argv=[f"config={tok_config}", f"training.device={device}",
                          f"training.per_device_batch_size={s['tok_batch']}",
                          f"losses.discriminator_start={s['tok_gate']}",
                          f"training.max_train_steps={s['tok_steps']}",
                          f"experiment.output_dir={os.path.join(work, 'dp_tok')}"],
                eval_argv=[f"config={gen_config}", f"eval.device={device}",
                           f"eval.total_samples={s['eval_samples']}",
                           f"eval.batch_size={s['eval_batch']}", "eval.stats_path=",
                           "experiment.vqgan_checkpoint=", "experiment.generator_checkpoint=",
                           f"experiment.output_dir={os.path.join(work, 'dp_eval')}"]
                + ([f"model.mlm_model.depth={s['eval_depth']}"] if s.get("eval_depth") else []))


def _reference_step(torch, spec: dict, cuda: bool) -> tuple:
    """One process's step at the global batch (`_grad_step`): (parameters
    before, reduced gradients, parameters after, metrics)."""
    model, vq_node, data = _grad_step_inputs(torch, spec)
    params_0 = {n: p.detach().float().cpu().clone() for n, p in model.named_parameters()}
    grads_1, reduce_1 = [], []
    params_1, metrics_1 = _grad_step(torch, spec, model, vq_node, data, grads_1, reduce_1)
    del model
    if cuda:
        torch.cuda.empty_cache()
    return params_0, grads_1, params_1, metrics_1


def _check_combined(torch, spec: dict, s: dict, world: int, reference: tuple, cuda: bool,
                    card: str, tag: str) -> dict:
    """`_rank_combined`'s results against one process: b, the reduced
    gradients and updates (`DP_GRAD_TOL`); d, every rank's Stage-I state
    equal after every step; e, the merged eval moments against one
    accumulator fed every rank's features and logits at their global
    indices (float64; the Inception Score too), and the block's launches
    per rank."""
    import numpy as np

    from maskbit_tpu_torch.eval.adm import AdmMomentAccumulator

    work = spec["work"]
    ranks = _rank_results(work, "combined", world)
    params_0, grads_1, params_1, metrics_1 = reference
    out = {"ranks": ranks}
    # b. the reduced gradients against one process
    gap = _check_grads(torch, os.path.join(work, "dp_grads.pt"), grads_1, params_0, params_1)
    tol = DP_GRAD_TOL if cuda else DP_GRAD_TOL_CPU
    log(f"[{tag}] b. one step, depth {s['grad_depth']}, {world} ranks x batch {s['batch']} vs 1 "
        f"process x batch {world * s['batch']} ({'bf16' if cuda else 'float32'}): reduced "
        f"gradients relative L2 {gap['grad_rel_l2']:.3e} (tol {tol['grad_rel_l2']:g}), worst "
        f"tensor {gap['grad_worst_tensor_rel_l2']:.3e}; updates relative L2 "
        f"{gap['update_rel_l2']:.3e}, same sign {gap['update_same_sign']:.6f} (tol "
        f">= {tol['update_same_sign']}); ranks equal {[r['grad_ranks_agree'] for r in ranks]}; "
        f"loss per rank {[r['grad_loss'] for r in ranks]} vs {float(metrics_1['mlm_loss'])}; "
        f"all-reduce {[r['grad_all_reduce_s'] for r in ranks]} s; step "
        f"{[round(r['grad_step_s'], 3) for r in ranks]} s; train-state bytes per rank "
        f"{[r['state_bytes'] for r in ranks]}, peak {[r['peak_bytes'] for r in ranks]}; backend "
        f"{[r['backend'] for r in ranks]} [{card}]")
    if (gap["grad_rel_l2"] > tol["grad_rel_l2"]
            or gap["update_same_sign"] < tol["update_same_sign"]
            or not all(r["grad_ranks_agree"] for r in ranks)):
        raise AssertionError(f"reduced gradients disagree: {gap}")
    out["grads"] = dict(gap, tol=tol, depth=s["grad_depth"])

    # d. Stage I: every rank's state equal after every step
    for r in ranks:
        tok = r["tokenizer"]
        log(f"[{tag}] d. Stage I, rank: ranks equal after each step {tok['agree']}; "
            f"LeCam {tok['lecam']}; total loss {tok['total_loss']}; discriminator factor "
            f"{tok['d_factor']}; step s {[round(x, 3) for x in tok['step_s']]} [{card}]")
        if not all(tok["agree"]) or tok["d_factor"] != [0.0] * s["tok_gate"] + [1.0] * (
                s["tok_steps"] - s["tok_gate"]) or not np.isfinite(tok["total_loss"]).all():
            raise AssertionError(f"Stage I across ranks: {tok}")
    out["tokenizer"] = [r["tokenizer"] for r in ranks]

    # e. eval_maskbit: the merged moments against one accumulator of every sample
    evals = [torch.load(os.path.join(work, f"dp_eval_rank{r}.pt"), weights_only=False)
             for r in range(world)]
    one = AdmMomentAccumulator(total_samples=s["eval_samples"])
    for r, e in enumerate(evals):  # rank r's sample j is global sample j * world + r
        one.update(e["features"], e["logits"], np.arange(len(e["features"])) * world + r)
    eval_gap = max(float(np.abs(e[k] - getattr(one, k)).max() / np.abs(getattr(one, k)).max())
                   for e in evals for k in ("act_sum", "act_outer"))
    is_merged, is_one = evals[0]["results"]["InceptionScore"], one.inception_score()
    per_rank = -(-s["eval_samples"] // world)
    batches = -(-per_rank // s["eval_batch"])
    mlm = _model_node(spec["gen_config"])["mlm_model"]
    want = int(s.get("eval_depth") or mlm["depth"]) * int(mlm["num_steps"]) * batches
    wall = max(r["eval_s"] for r in ranks)
    for r in ranks:
        log(f"[{tag}] e. eval_maskbit rank: {r['eval_local_samples']} of {r['eval_count']} "
            f"samples, launches {r['eval_launches']} (expected {want} each); {r['eval_s']:.1f} s "
            f"[{card}]")
    log(f"[{tag}] e. merged moments vs one accumulator of the {one.count} samples: max relative "
        f"gap {eval_gap:.3e} (tol 1e-12); IS merged {is_merged!r}, one {is_one!r}; "
        f"{s['eval_samples']} samples in {wall:.1f} s = {s['eval_samples'] / wall:.3f} img/s "
        f"over {world} processes [{card}]")
    if (eval_gap > 1e-12 or abs(is_merged - is_one) > 1e-9 * abs(is_one)
            or any(r["eval_count"] != s["eval_samples"] for r in ranks)
            or one.count != s["eval_samples"]
            or (cuda and any(v != want for r in ranks for v in r["eval_launches"].values()))):
        raise AssertionError(f"the sharded eval: gap {eval_gap}, IS {is_merged} vs {is_one}, "
                             f"{ranks}")
    out.update(eval_gap=eval_gap, eval_is=[is_merged, is_one], eval_wall_s=wall,
               eval_img_s=s["eval_samples"] / wall)
    return out


def phase_distributed(torch, device_info, device="cuda", gen_config=CONFIG,
                      tok_config=TOKENIZER_CONFIGS[0], sizes=None) -> dict:
    """Data-parallel runs across processes (phase 11): two ranks share the
    card (gloo over CUDA tensors; NCCL refuses two ranks on one device).
    device="cpu" with tiny configs and `sizes` rehearses the phase (launches
    are then not checked)."""
    import maskbit_tpu_torch
    from maskbit_tpu_torch.eval import inception as inc

    s = dict(DP_SIZES, **(sizes or {}))
    cuda = device == "cuda"
    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_data")  # git-ignored; checkpoints ~5 GB
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    if cuda:
        torch.cuda.empty_cache()
    tree = os.path.dirname(os.path.dirname(os.path.abspath(maskbit_tpu_torch.__file__)))
    base = {"tree": tree, "device": device, "work": work}
    common = [f"config={gen_config}", f"training.device={device}",
              f"dataset.params.token_shards_path_or_url={_token_shards(work, gen_config, 512)}",
              "experiment.vqgan_checkpoint=", "experiment.log_every=1",
              "experiment.generate_every=100000", "experiment.eval_every=100000"]
    out = {}
    try:
        # a. two ranks of train_maskbit; SIGTERM to rank 1; a resume
        out["stage2"] = _stop_and_resume(base, common, 2, s["batch"], s["stop_depth"],
                                         os.path.join(work, "dp_train"), s["timeout"], cuda,
                                         device_info["card"], "stage2", "distributed a.")

        # c. one NCCL rank, and b, d, e in a second pair of ranks, at once
        weights = os.path.join(work, "pt_inception.pth")
        torch.save(inc.random_inception_state(0), weights)
        resnet = os.path.join(work, "resnet50.pth")
        _random_resnet50(torch, resnet)
        out_c = os.path.join(work, "dp_nccl")
        nccl = _spawn_ranks(dict(base, task="train_cli", tag="nccl", argv=common + [
            f"model.mlm_model.depth={s['nccl_depth']}", f"training.per_device_batch_size={s['batch']}",
            f"training.max_train_steps={s['nccl_steps']}", f"experiment.output_dir={out_c}"]),
            1, env={"MASKBIT_DISTRIBUTED": "1"})
        spec = _combined_spec(base, work, gen_config, tok_config, device, s, 2)
        combined = _spawn_ranks(spec, 2, env={"MASKBIT_INCEPTION_WEIGHTS": weights,
                                             "MASKBIT_ADM_PB": "", "MASKBIT_RESNET50_WEIGHTS": resnet})
        try:
            reference = _reference_step(torch, spec, cuda)  # b's one process, meanwhile
        finally:
            _wait_ranks(nccl, "nccl", s["timeout"])
            _wait_ranks(combined, "combined", s["timeout"])
        (nccl_result,) = _rank_results(work, "nccl", 1)
        log(f"[distributed] c. one rank, backend {nccl_result['backend']}: {nccl_result['steps']} "
            f"steps at depth {s['nccl_depth']}, losses {nccl_result['losses']}, launches "
            f"{nccl_result['launches']}")
        if nccl_result["steps"] != s["nccl_steps"] or (
                cuda and nccl_result["backend"] != "nccl"):
            raise AssertionError(f"the NCCL rank: {nccl_result}")
        if cuda and nccl_result["launches"]["dropout_attention_fwd"] != s["nccl_depth"] * s[
                "nccl_steps"]:
            raise AssertionError(f"the NCCL rank's launches {nccl_result['launches']}")
        out["nccl"] = nccl_result
        out.update(_check_combined(torch, spec, s, 2, reference, cuda, device_info["card"],
                                   "distributed"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[distributed] phase time {out['seconds']:.1f} s")
    return out


# phase 12: the fsdp and tensor axes, two ranks sharing the card. Stage-II
# per-rank batch (global 32 under fsdp=2; under tensor=2 the ranks hold the
# same 32 rows), steps per run (the first checked against one process, the
# second with the collectives timed, the rest timed as steps), sampler
# labels per rank under tensor=2, Stage I's per-rank batch and steps, each
# launch's limit (s); the depth cut from 24 to make room for phase 16, then
# to 6 (phase 11's gradient check's) for phase 18
SH_SIZES = {"batch": 16, "depth": 6, "steps": 4, "sample": 2, "tok_batch": 8, "tok_steps": 3,
            "timeout": 600}
SH_MESHES = (("fsdp2", {"fsdp": 2, "tensor": 1}), ("tensor2", {"fsdp": 1, "tensor": 2}))
# the state a rank keeps under fsdp=2 against data=2's (replicated): half,
# and the replicated leaves (none at the flagship's widths) would add to it
SH_STATE_RATIO = 0.6


def _rank_sharded(torch, spec) -> None:
    """A rank of phase 12 on mesh `spec["mesh"]`: the flagship's steps with
    injected global draws (the first update against one process, the
    collectives timed apart, the dropout kernels' launches and heads
    counted), then under fsdp=2 a save for the one-process resume and the
    tokenizer's steps, under tensor=2 a few samples with the whole EMA
    weights through the attention block."""
    import numpy as np
    import torch.distributed as dist

    import maskbit_tpu_torch.nn.transformer as transformer
    from maskbit_tpu_torch.cli import train_tokenizer
    from maskbit_tpu_torch.cli.common import build_module, random_init_, synthetic_batches
    from maskbit_tpu_torch.core.checkpoint import CheckpointManager
    from maskbit_tpu_torch.core.config import config_from_cli
    from maskbit_tpu_torch.core.ema import swapped_in
    from maskbit_tpu_torch.losses.mlm import MLMLossConfig
    from maskbit_tpu_torch.nn import attention_block as ab
    from maskbit_tpu_torch.nn import dropout_attention as da
    from maskbit_tpu_torch.models.tokenizer import ConvVQModel
    from maskbit_tpu_torch.parallel import mesh as pm
    from maskbit_tpu_torch.parallel import zero
    from maskbit_tpu_torch.parallel.zero import ShardedParams
    from maskbit_tpu_torch.sampling.sample import SamplingConfig, make_sampler
    from maskbit_tpu_torch.train.generator_trainer import (
        init_generator_train_state,
        make_generator_train_step_from_tokens,
    )
    from maskbit_tpu_torch.train.optim import make_optimizer

    device = pm.maybe_init_distributed(torch.device(spec["device"]))
    mesh = pm.init_mesh(pm.MeshConfig(**spec["mesh"]))
    rank, cuda = pm.process_index(), str(device).startswith("cuda")
    out = {"mesh": spec["mesh"], "coords": list(mesh.coords)}
    model, vq, data = _grad_step_inputs(torch, spec)
    store = ShardedParams(model)
    params = store.parameters()
    opt = make_optimizer(params, lambda t: 1e-4, beta2=0.96, weight_decay=0.045,
                         norm_fn=store.norm_fn(params))
    state = init_generator_train_state(model, opt, store=store)
    step = make_generator_train_step_from_tokens(model, vq["codebook_size"], MLMLossConfig(),
                                                 class_label_dropout=0.1,
                                                 ema_kwargs={"decay": 0.9999})
    b = data["tokens"].shape[0] // pm.batch_shard_count()
    rows = lambda x: torch.from_numpy(  # noqa: E731
        pm.local_rows(x, b, pm.batch_group())).to(device)
    heads = []
    real_attention = transformer.dropout_attention

    def counted(q, k, v, seeds, rate):
        heads.append(int(q.shape[2]))
        return real_attention(q, k, v, seeds, rate)

    transformer.dropout_attention = counted
    for key in da.launches:
        da.launches[key] = 0
    captured, reduce_s, step_s, comm_by_step = [], [], [], {}
    real_staged = pm._staged
    half_steps = spec.get("half_steps", ())
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for i in range(spec["steps"]):
        real_reduce = _timed_all_reduce(torch, device, reduce_s, captured) if i == 0 else None
        # the collectives of step 2 on (of step 2 only without `half_steps`)
        # timed; on `half_steps` with half types left in half precision, as
        # the staging left them under NCCL before it widened them
        untime = None
        if i == 1 or (half_steps and i >= 1):
            comm_by_step[i] = {"half": i in half_steps}
            untime = _timed_collectives(torch, device, comm_by_step[i])
        if i in half_steps:
            pm._staged = lambda t: t.to(pm._comm_device())
        t0 = _sync(torch, device)
        try:
            state, metrics = step(state, rows(data["tokens"]), rows(data["labels"]),
                                  injected=data["injected"])
        finally:
            pm._staged = real_staged
            if real_reduce is not None:
                zero.ShardedParams.reduce_scatter_grads = real_reduce
            if untime is not None:
                untime()
        step_s.append(_sync(torch, device) - t0)
        if i == 0:
            whole = {n: t.float().cpu().clone() for n, t in store.whole_params().items()}
            out["loss"] = float(metrics["mlm_loss"])
    if rank == 0:  # after the steps, which the other ranks would wait for
        torch.save({"grads": captured, "params": whole},
                   os.path.join(spec["work"], f"sh_{spec['tag']}_grads.pt"))
    del whole, captured
    transformer.dropout_attention = real_attention
    comm = {k: v for k, v in comm_by_step.pop(1).items() if k != "half"}
    out.update(step_s=step_s, comm_s=comm, comm_by_step=comm_by_step, reduce_s=reduce_s,
               backend=dist.get_backend(), launches=dict(da.launches),
               heads=sorted(set(heads)), state_bytes=_state_bytes(state),
               whole_state_bytes=4 * sum(4 * int(np.prod(s)) for s in store.global_shapes.values()),
               peak_bytes=torch.cuda.max_memory_allocated() if cuda else None,
               split=len(store.splits), params=len(store.names))
    if spec.get("save", spec["mesh"]["fsdp"] > 1):
        # the state saved from the slices, for the one-process resume
        t0 = time.perf_counter()
        ckpt = CheckpointManager(os.path.join(spec["work"], "sh_ckpt"))
        ckpt.save(state.step, state, blocking=True)
        ckpt.close()
        out["save_s"] = time.perf_counter() - t0
        whole = state.state_dict()
        out["digest"] = _digest(list(whole["params"].values())
                                + list(whole["ema"]["params"].values())
                                + whole["opt"]["mu"] + whole["opt"]["nu"])
        del whole
    else:
        # generation: the whole EMA weights, the attention block on every layer
        mlm = _model_node(spec["gen_config"])["mlm_model"]
        tokenizer = build_module(lambda: ConvVQModel.from_config(vq, dtype=model.dtype), device)
        random_init_(tokenizer, torch.Generator(device=device).manual_seed(0))
        tokenizer.to(model.dtype)
        cfg = SamplingConfig.from_config(mlm, vq)._replace(
            patch_size=spec["res"] // 2 ** (vq.get("num_resolutions", 5) - 1))
        sampler = make_sampler(model, tokenizer, cfg)
        block_heads = []
        real_block = transformer.fused_attention_block

        def counted_block(*args, num_heads, **kwargs):
            block_heads.append(int(num_heads))
            return real_block(*args, num_heads=num_heads, **kwargs)

        transformer.fused_attention_block = counted_block
        ab.launches = 0
        da.launches["fused_attention"] = 0
        t0 = _sync(torch, device)
        try:
            with swapped_in(state.ema, model, store), torch.inference_mode():
                model.eval()
                images, _ = sampler(torch.arange(spec["sample"], device=device),
                                    torch.Generator(device=device).manual_seed(rank))
        finally:
            transformer.fused_attention_block = real_block
        out["sample_s"] = _sync(torch, device) - t0
        out["block_heads"] = sorted(set(block_heads))
        out["sample_finite"] = bool(torch.isfinite(images.float()).all())
        out["sample_launches"] = {"attention_block": ab.launches,
                                  "fused_attention": da.launches["fused_attention"]}
        out["restored_tensor_local"] = all(
            m.tensor_group is not None for m in model.modules() if hasattr(m, "num_heads"))
    del model, state, step, store
    if cuda:
        torch.cuda.empty_cache()

    if spec.get("tok_argv"):
        # Stage I at fsdp=2: the gathered state equal on both ranks after every step
        run = train_tokenizer.build_training(config_from_cli(spec["tok_argv"]),
                                             train_tokenizer._logger())
        tstate, tstep = run["state"], run["train_step"]
        batches = synthetic_batches(spec["tok_batch"], spec["tok_res"], seed=rank)
        tok = {"agree": [], "step_s": [], "total_loss": []}
        for _ in range(spec["tok_steps"]):
            images = torch.from_numpy(next(batches)["image"]).to(device)
            t0 = _sync(torch, device)
            tstate, m = tstep(tstate, images)
            tok["step_s"].append(_sync(torch, device) - t0)
            whole = tstate.state_dict()
            gathered = pm.process_allgather_f64(_digest(
                list(whole["gen_params"].values()) + list(whole["disc_params"].values())
                + list(whole["ema"]["params"].values())))
            tok["agree"].append(bool((gathered == gathered[0]).all()))
            tok["total_loss"].append(float(m["total_loss"]))
        gs, ds = tstate.gen_store, tstate.disc_store
        tok["state_bytes"] = _resident_bytes(
            [p for st in (gs, ds) for p in list(st.params.values()) + list(st.shards.values())]
            + [t for o in (tstate.gen_opt, tstate.disc_opt) for t in o.mu + o.nu]
            + list(tstate.ema.params.values()))
        tok["whole_state_bytes"] = sum(4 * int(np.prod(s)) for st in (gs, ds)
                                       for s in st.global_shapes.values()) * 3 + sum(
            4 * int(np.prod(gs.global_shapes[n])) for n in tstate.ema.params)
        tok["split"] = [len(gs.splits), len(gs.names), len(ds.splits), len(ds.names)]
        out["tokenizer"] = tok
    _rank_write(spec, rank, out)


def _check_sharded_steps(torch, spec: dict, ranks: list, reference: tuple, steps: int,
                         heads: int, cuda: bool, card: str, label: str) -> dict:
    """`_rank_sharded`'s first update against one process's step on the
    global batch (`DP_GRAD_TOL`), and per rank the heads and the dropout
    kernels' launches (depth x steps each)."""
    params_0, grads_1, params_1, metrics_1 = reference
    depth, tensor = spec["grad_depth"], spec["mesh"]["tensor"]
    gap = _check_grads(torch, os.path.join(spec["work"], f"sh_{spec['tag']}_grads.pt"), grads_1,
                       params_0, params_1)
    tol = DP_GRAD_TOL if cuda else DP_GRAD_TOL_CPU
    log(f"[{label}] first update, depth {depth}, {len(ranks)} ranks vs 1 process x batch "
        f"{spec['global_batch']} ({'bf16' if cuda else 'float32'}): reduced gradients relative "
        f"L2 {gap['grad_rel_l2']:.3e} (tol {tol['grad_rel_l2']:g}), worst tensor "
        f"{gap['grad_worst_tensor_rel_l2']:.3e}; updates relative L2 "
        f"{gap['update_rel_l2']:.3e}, same sign {gap['update_same_sign']:.6f} (tol >= "
        f"{tol['update_same_sign']}); loss per rank {[r['loss'] for r in ranks]} vs "
        f"{float(metrics_1['mlm_loss'])} [{card}]")
    for r in ranks:
        comm = ", ".join(f"{k} {v:.4f}" for k, v in sorted(r["comm_s"].items()))
        later = "; ".join(
            f"step {int(i) + 1}{' (half types left in half)' if c['half'] else ''}: "
            + ", ".join(f"{k} {v:.4f}" for k, v in sorted(c.items()) if k != "half")
            for i, c in sorted(r["comm_by_step"].items(), key=lambda kv: int(kv[0])))
        log(f"[{label}] rank {r['coords']} ({r['backend']}): {r['split']} of {r['params']} "
            f"parameters split; state {r['state_bytes'] / 2**30:.3f} GiB of "
            f"{r['whole_state_bytes'] / 2**30:.3f} whole; peak "
            f"{(r['peak_bytes'] or 0) / 2**30:.2f} GiB; steps "
            f"{[round(x, 3) for x in r['step_s']]} s; collectives of step 2: {comm} s"
            + (f"; {later} s" if later else "") + f"; dropout launches {r['launches']} at "
            f"{r['heads']} heads [{card}]")
    if (gap["grad_rel_l2"] > tol["grad_rel_l2"]
            or gap["update_same_sign"] < tol["update_same_sign"]):
        raise AssertionError(f"{label}: the first update disagrees with one process: {gap}")
    for r in ranks:
        if r["heads"] != [heads // tensor]:
            raise AssertionError(f"{label}: the kernels saw heads {r['heads']}")
        if cuda and (r["launches"]["dropout_attention_fwd"] != depth * steps
                     or r["launches"]["dropout_attention_bwd"] != depth * steps):
            raise AssertionError(f"{label}: launches {r['launches']}")
    return {"grads": dict(gap, tol=tol), "ranks": ranks}


def phase_sharded(torch, device_info, device="cuda", gen_config=CONFIG,
                  tok_config=TOKENIZER_CONFIGS[0], sizes=None, data_parallel=None) -> dict:
    """The fsdp and tensor axes across processes (phase 12): two ranks share
    the card (gloo), first at parallel.fsdp=2, then at tensor=2.
    `data_parallel`: phase 11's ranks (their state bytes and peak memory at
    data=2, the same per-rank batch), for the comparison. device="cpu" with
    tiny configs and `sizes` rehearses the phase (launches and memory are
    then not checked)."""
    import numpy as np

    import maskbit_tpu_torch

    s = dict(SH_SIZES, **(sizes or {}))
    cuda = device == "cuda"
    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_sharded")  # git-ignored; ~5 GB
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    if cuda:
        torch.cuda.empty_cache()
    tree = os.path.dirname(os.path.dirname(os.path.abspath(maskbit_tpu_torch.__file__)))
    model_cfg = _model_node(gen_config)
    mlm = model_cfg["mlm_model"]
    depth, heads = s["depth"], int(mlm["heads"])
    res = int(mlm.get("img_size", 256))
    base = dict(tree=tree, device=device, work=work, task="sharded", gen_config=gen_config,
                grad_depth=depth, global_batch=2 * s["batch"], steps=s["steps"],
                sample=s["sample"], res=res, tok_batch=s["tok_batch"], tok_steps=s["tok_steps"],
                tok_res=int(s.get("tok_res", 256)))
    resnet = os.path.join(work, "resnet50.pth")
    _random_resnet50(torch, resnet)
    out = {"meshes": {}}
    try:
        for name, axes in SH_MESHES:
            spec = dict(base, tag=f"sharded_{name}", mesh=axes)
            if axes["fsdp"] > 1:
                spec["tok_argv"] = [f"config={tok_config}", f"training.device={device}",
                                    f"parallel.fsdp={axes['fsdp']}",
                                    f"training.per_device_batch_size={s['tok_batch']}",
                                    f"training.max_train_steps={s['tok_steps']}",
                                    "losses.discriminator_start=1",
                                    f"experiment.output_dir={os.path.join(work, 'tok')}"]
            procs = _spawn_ranks(spec, 2, env={"MASKBIT_RESNET50_WEIGHTS": resnet})
            try:
                if name == "fsdp2":  # one process at the global batch, meanwhile
                    reference = _reference_step(torch, spec, cuda)
            finally:
                _wait_ranks(procs, spec["tag"], s["timeout"])
            ranks = _rank_results(work, spec["tag"], 2)
            mesh_out = _check_sharded_steps(torch, spec, ranks, reference, s["steps"], heads, cuda,
                                            device_info["card"], f"sharded {name}")
            if name == "fsdp2":
                dp_state = ([r["state_bytes"] for r in data_parallel] if data_parallel
                            else [r["whole_state_bytes"] for r in ranks])
                ratio = max(r["state_bytes"] for r in ranks) / min(dp_state)
                dp_peak = [r.get("peak_bytes") for r in data_parallel] if data_parallel else None
                log(f"[sharded] fsdp=2 state per rank {[r['state_bytes'] for r in ranks]} B vs "
                    f"data=2 {dp_state} B ({'phase 11' if data_parallel else 'replicated'}): "
                    f"ratio {ratio:.4f} (<= {SH_STATE_RATIO}); peak per rank "
                    f"{[r['peak_bytes'] for r in ranks]} B vs data=2 {dp_peak} B "
                    f"[{device_info['card']}]")
                if ratio > SH_STATE_RATIO:
                    raise AssertionError(f"fsdp=2 keeps {ratio:.3f} of data=2's state")
                mesh_out.update(state_ratio=ratio, data_parallel_state=dp_state,
                                data_parallel_peak=dp_peak)
                # the save under fsdp=2, resumed in one process
                from maskbit_tpu_torch.core.checkpoint import CheckpointManager
                from maskbit_tpu_torch.losses.mlm import MLMLossConfig
                from maskbit_tpu_torch.train.generator_trainer import (
                    init_generator_train_state,
                    make_generator_train_step_from_tokens,
                )
                from maskbit_tpu_torch.train.optim import make_optimizer

                model, vq, data = _grad_step_inputs(torch, spec)
                opt = make_optimizer(model.parameters(), lambda t: 1e-4, beta2=0.96,
                                     weight_decay=0.045)
                state = init_generator_train_state(model, opt)
                t0 = time.perf_counter()
                restored = CheckpointManager(os.path.join(work, "sh_ckpt")).restore_latest(state)
                restore_s = time.perf_counter() - t0
                sd = state.state_dict()
                digest = _digest(list(sd["params"].values()) + list(sd["ema"]["params"].values())
                                 + sd["opt"]["mu"] + sd["opt"]["nu"])
                step = make_generator_train_step_from_tokens(
                    model, vq["codebook_size"], MLMLossConfig(), class_label_dropout=0.1,
                    ema_kwargs={"decay": 0.9999})
                _, m = step(state, torch.from_numpy(data["tokens"]).to(device),
                            torch.from_numpy(data["labels"]).to(device), injected=data["injected"])
                resumed = {"step": restored[1], "bitwise": digest == ranks[0]["digest"],
                           "next_loss": float(m["mlm_loss"]), "restore_s": restore_s,
                           "save_s": [r["save_s"] for r in ranks]}
                log(f"[sharded] fsdp=2 save (step {restored[1]}, {resumed['save_s']} s per "
                    f"rank) resumed in one process in {restore_s:.1f} s: state equal bit for bit "
                    f"{resumed['bitwise']}; next step's loss {resumed['next_loss']:.4f}")
                if not resumed["bitwise"] or restored[1] != s["steps"] or not np.isfinite(
                        resumed["next_loss"]):
                    raise AssertionError(f"the one-process resume: {resumed}")
                mesh_out["resume"] = resumed
                del model, state, step, sd
                if cuda:
                    torch.cuda.empty_cache()
                for r in ranks:
                    tok = r["tokenizer"]
                    log(f"[sharded] fsdp=2 Stage I rank {r['coords']}: {tok['split'][0]} of "
                        f"{tok['split'][1]} tokenizer and {tok['split'][2]} of {tok['split'][3]} "
                        f"discriminator parameters split; state {tok['state_bytes']} of "
                        f"{tok['whole_state_bytes']} B; ranks equal {tok['agree']}; total loss "
                        f"{tok['total_loss']}; steps {[round(x, 3) for x in tok['step_s']]} s "
                        f"[{device_info['card']}]")
                    if not all(tok["agree"]) or not np.isfinite(tok["total_loss"]).all() or (
                            tok["state_bytes"] > SH_STATE_RATIO * tok["whole_state_bytes"]):
                        raise AssertionError(f"Stage I at fsdp=2: {tok}")
            else:
                for r in ranks:
                    log(f"[sharded] tensor=2 rank {r['coords']}: {s['sample']} samples with the "
                        f"whole EMA weights in {r['sample_s']:.2f} s, launches "
                        f"{r['sample_launches']} at {r['block_heads']} heads; finite "
                        f"{r['sample_finite']}; tensor-local again {r['restored_tensor_local']}")
                    want = depth * int(mlm["num_steps"])
                    if not (r["sample_finite"] and r["restored_tensor_local"]) or (
                            r["block_heads"] != [heads]) or (
                            cuda and any(v != want for v in r["sample_launches"].values())):
                        raise AssertionError(f"tensor=2 generation: {r}")
            out["meshes"][name] = mesh_out
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[sharded] phase time {out['seconds']:.1f} s")
    return out


def _jpeg_header_present() -> bool:
    """Whether g++ finds libjpeg's header (the native decoder's build needs it)."""
    try:
        proc = subprocess.run(["g++", "-fsyntax-only", "-x", "c++", "-"],
                              input="#include <cstdio>\n#include <jpeglib.h>\n",
                              capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return proc.returncode == 0


def _write_photo_shards(pattern: str, n: int, h: int, w: int) -> None:
    """n synthetic h x w JPEGs (ImageNet's typical photo is 500 x 375):
    smooth random colour fields with grain (std 4), quality 90, as tar
    shards of 128 through the port's `ShardWriter`."""
    import numpy as np
    from PIL import Image

    from maskbit_tpu_torch.data.shard_writer import ShardWriter

    rng = np.random.default_rng(1)
    writer = ShardWriter(pattern, maxcount=128)
    for i in range(n):
        low = Image.fromarray(rng.uniform(0, 255, (6, 8, 3)).astype(np.uint8))
        arr = np.asarray(low.resize((w, h), Image.BICUBIC), np.float32)
        arr = np.clip(arr + rng.normal(0, 4, arr.shape), 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", quality=90)
        writer.write(f"{i:06d}", buf.getvalue(), i % 1000)
    writer.close()


def _decode_rates(work: str, res: int, interpolation: str, stage2_step_s, photos: int,
                  batch: int) -> dict:
    """(d) The tar reader on `photos` synthetic 500 x 375 JPEGs at `batch`:
    the thread backend (PIL) with 1 and 8 decode threads and the process
    backend with 8; the native decoder likewise when g++ finds libjpeg's
    header, held against the PIL path."""
    import numpy as np

    from maskbit_tpu_torch import native
    from maskbit_tpu_torch.data.tar_reader import TarImageDataset, batched
    from maskbit_tpu_torch.data.transforms import TrainTransform

    header = _jpeg_header_present()
    build_s = None
    if header:
        t0 = time.perf_counter()
        if not native.is_available():
            raise AssertionError(f"jpeglib.h is present but the native decoder did not build: "
                                 f"{native.build_error()}")
        build_s = time.perf_counter() - t0
    else:
        log("[split] native decode: jpeglib.h is absent on this machine (g++ cannot include "
            "it); the native decoder is optional, as in JAX: only the PIL backends are timed")
    pattern = os.path.join(work, "photos", "img-%04d.tar")
    os.makedirs(os.path.dirname(pattern))
    _write_photo_shards(pattern, photos, 375, 500)
    shards = os.path.join(work, "photos", f"img-{{0000..{(photos - 1) // 128:04d}}}.tar")

    def stream(backend, threads):
        transform = TrainTransform(resolution=res, min_scale=0.8, use_aspect_ratio_aug=False,
                                   interpolation=interpolation, seed=0)
        ds = TarImageDataset(shards, transform, resample=False, seed=0,
                             num_decode_threads=threads, decode_backend=backend)
        return batched(iter(ds), batch, drop_last=False)

    rates = {}
    runs = [("thread", 1), ("thread", 8), ("process", 8)]
    if header:
        runs += [("native", 1), ("native", 8)]
    step = "" if stage2_step_s is None else (
        f"; phase 6's Stage-II step ({stage2_step_s * 1e3:.1f} ms at batch 32) needs "
        f"{32 / stage2_step_s:.1f} img/s")
    for backend, threads in runs:
        t0 = time.perf_counter()
        n = sum(len(b["class_id"]) for b in stream(backend, threads))
        dt = time.perf_counter() - t0
        rates[f"{backend}_{threads}"] = n / dt
        note = " (the pool's start-up included)" if backend == "process" else ""
        log(f"[split] decode {backend:7s} x{threads}: {n} JPEGs of 500x375 -> {res} px "
            f"{interpolation} in {dt:.3f} s{note} = {n / dt:.1f} img/s = "
            f"{dt / n * batch * 1e3:.1f} ms a batch of {batch}{step}")
    out = {"jpeglib": header, "build_s": build_s, "img_per_s": rates}
    if header:  # native against PIL, JAX's tolerances (tests/test_native_decode.py)
        mean_tol = 0.012 if interpolation == "bicubic" else 0.01
        worst = 0.0
        for a, b in zip(stream("thread", 8), stream("native", 8), strict=True):
            if not np.array_equal(a["class_id"], b["class_id"]):
                raise AssertionError("native decode: labels or order differ from the PIL path")
            worst = max(worst, float(np.abs(a["image"] - b["image"]).mean(axis=(1, 2, 3)).max()))
        log(f"[split] native vs PIL: largest per-image mean |diff| {worst:.5f} (limit "
            f"{mean_tol}); build {build_s:.2f} s")
        if worst >= mean_tol:
            raise AssertionError(f"native decode strays from PIL: {worst} >= {mean_tol}")
        out["worst_mean_diff"] = worst
    return out


def _stopped(sampler) -> bool:
    """No worker process of a split sampler is left running."""
    return all(not p.is_alive() for p in sampler._procs)


def phase_split(torch, device_info, device="cuda", gen_config=CONFIG, sizes=None,
                stage2_step_s=None) -> dict:
    """Phase 13: one batch split over a host's devices (`sampling/serve.py`,
    a worker process per entry), over two entries naming the one card, and
    the native JPEG decoder. device="cpu" rehearses it with a tiny config."""
    from maskbit_tpu_torch.cli import eval_maskbit
    from maskbit_tpu_torch.cli import serve as serve_cli
    from maskbit_tpu_torch.cli.common import load_generation_models
    from maskbit_tpu_torch.core.config import config_from_cli, load_config
    from maskbit_tpu_torch.eval import inception as inc
    from maskbit_tpu_torch.sampling import serve as split
    from maskbit_tpu_torch.sampling.sample import make_sampler

    sizes = dict(SPLIT_SIZES, **(sizes or {}))
    t_phase = time.perf_counter()
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    devices = [dev, dev]
    config = load_config(gen_config)
    mlm = config.model.mlm_model
    depth, steps = int(mlm["depth"]), int(mlm["num_steps"])
    work = os.path.join(ROOT, "build", "chip_smoke_split")  # git-ignored
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    real_local, real_make = split.local_devices, split.make_sharded_sampler
    made = []
    out = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    def block_launches(counts):
        return [c["attention_block"] for c in counts]

    try:
        # a. the split sampler at serve batch 8, injected draws
        tok, gen, cfg, _, _ = load_generation_models(
            config_from_cli([f"config={gen_config}", "experiment.vqgan_checkpoint=",
                             "experiment.generator_checkpoint="]),
            logging.getLogger("chip_smoke.split"), dev, cast_weights=True)
        b, half = sizes["batch"], sizes["batch"] // 2
        n = cfg.patch_size ** 2
        g = torch.Generator(device=dev).manual_seed(13)
        draws = (torch.randint(0, cfg.mask_token, (cfg.num_steps, b, n, cfg.codebook_splits),
                               generator=g, device=dev, dtype=torch.int32),
                 -torch.log(torch.empty((cfg.num_steps, b, n, cfg.codebook_splits),
                                        device=dev).exponential_(generator=g)))
        labels = torch.arange(b, device=dev, dtype=torch.int64) * 97 % 1000
        whole = make_sampler(gen, tok, cfg)
        t0 = time.perf_counter()
        sharded = split.make_sharded_sampler(gen, tok, cfg, devices)
        start_s = time.perf_counter() - t0
        # each replica holds this process's weights, bit for bit
        want_state = [{k: v.cpu() for k, v in m.state_dict().items()} for m in (gen, tok)]
        same_weights = all(st.keys() == want.keys() and all(torch.equal(st[k], v)
                                                            for k, v in want.items())
                           for pair in sharded.replica_states() for st, want in zip(pair, want_state))
        del want_state
        rows = [slice(0, half), slice(half, b)]
        halves = [whole(labels[r], injected=tuple(d[:, r] for d in draws)) for r in rows]
        whole(labels, injected=draws)  # warm-ups: the batch-8 shapes, the workers' first call
        sharded(labels, injected=draws)
        whole_s, split_s = [], []
        for _ in range(2):
            t0 = sync()
            full = whole(labels, injected=draws)
            whole_s.append(sync() - t0)
            sharded.launch_counts(reset=True)
            t0 = sync()
            images, tokens = sharded(labels, injected=draws)
            split_s.append(sync() - t0)
            counts = sharded.launch_counts()
        per_replica = block_launches(counts)
        pids = sharded.pids
        sharded.close()
        want_images = torch.cat([h[0] for h in halves])
        want_tokens = torch.cat([h[1] for h in halves])
        gap = (images.float() - want_images.float()).abs().max().item()
        differ = (tokens != want_tokens).nonzero().tolist()
        whole_gap = (images.float() - full[0].float()).abs().max().item()
        agree = (tokens == full[1]).float().mean().item()
        log(f"[split] a. {len(devices)} worker processes {pids} on {[str(d) for d in devices]} "
            f"(started in {start_s:.2f} s, weights equal to this process's bit for bit: "
            f"{same_weights}) at batch {b} ({half} rows each), depth {depth}, {steps} steps, "
            f"injected draws: against two one-device calls at batch {half} on the same rows, "
            f"largest image gap {gap:.3e}, {len(differ)} tokens differ; against the whole batch "
            f"8 (other GEMM shapes, no gate): token agreement {agree:.4f}, largest image gap "
            f"{whole_gap:.3e}")
        log(f"[split]    wall of two calls each: split {split_s[0]:.3f}, {split_s[1]:.3f} s; "
            f"whole batch {whole_s[0]:.3f}, {whole_s[1]:.3f} s ({b / min(split_s):.3f} against "
            f"{b / min(whole_s):.3f} img/s) [{device_info['card']}]; launches per worker "
            f"{counts} (block: depth x steps = {depth * steps}); workers stopped "
            f"{_stopped(sharded)}")
        if gap != 0.0 or differ:
            raise AssertionError(f"the split differs from the half-batch calls: largest gap "
                                 f"{gap}, tokens {differ[:20]}")
        if not torch.isfinite(images.float()).all() or images.shape[0] != b:
            raise AssertionError(f"split images {tuple(images.shape)} not finite")
        if not same_weights or not _stopped(sharded):
            raise AssertionError(f"replica weights equal {same_weights}, workers stopped "
                                 f"{_stopped(sharded)}")
        if dev.type == "cuda" and per_replica != [depth * steps] * len(devices):
            raise AssertionError(f"launches per replica {per_replica}, expected "
                                 f"{depth * steps} each")
        out["sampler"] = {"gap": gap, "tokens_differ": len(differ), "whole_token_agreement": agree,
                          "whole_gap": whole_gap, "split_s": split_s, "whole_s": whole_s,
                          "start_s": start_s, "launches_per_replica": per_replica,
                          "launches": counts}
        del tok, gen, whole, sharded, halves, full, images, tokens

        # b. the server over two entries: a seeded request twice
        split.local_devices = lambda d: list(devices)
        split.make_sharded_sampler = lambda *a, **k: made.append(real_make(*a, **k)) or made[-1]
        argv = [f"config={gen_config}", f"serve.batch_size={b}", "serve.port=0",
                f"serve.device={device}", "serve.shard_local_devices=true",
                "experiment.vqgan_checkpoint=", "experiment.generator_checkpoint="]
        server, service = serve_cli.main(argv, serve_forever=False)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            base = f"http://127.0.0.1:{server.server_address[1]}"
            labels = list(range(1, b + 1))
            d1, t1 = _post(base, {"labels": labels, "seed": 7})
            d2, t2 = _post(base, {"labels": labels, "seed": 7})
        finally:
            server.shutdown()
            server.server_close()
            service.close()
        served = _images(d1)
        sharded_service = bool(made) and service._sampler is made[-1] and made[-1].devices == devices
        counts = made[-1].launch_counts() if made else []
        log(f"[split] b. cli.serve over {len(devices)} entries (split: {sharded_service}): "
            f"seeded {b}-label requests {t1:.3f} s, {t2:.3f} s, bytes equal {d1 == d2}; block "
            f"launches per worker {block_launches(counts)} over {service.device_calls} calls; "
            f"workers stopped with the server {bool(made) and _stopped(made[-1])}")
        if d1 != d2 or not sharded_service or served.shape[0] != b or not _stopped(made[-1]):
            raise AssertionError("the split server's seeded requests differ, or it did not "
                                 "split, or its workers outlived it")
        if dev.type == "cuda" and block_launches(counts) != [depth * steps * service.device_calls] * 2:
            raise AssertionError(f"the split server's launches {counts}")
        out["serve"] = {"request_s": [t1, t2], "launches_per_replica": block_launches(counts),
                        "device_calls": service.device_calls}
        del server, service

        # c. eval_maskbit in one process over two entries
        weights = os.path.join(work, "pt_inception.pth")
        torch.save(inc.random_inception_state(0), weights)
        saved = os.environ.get("MASKBIT_INCEPTION_WEIGHTS")
        os.environ["MASKBIT_INCEPTION_WEIGHTS"] = weights
        made.clear()
        try:
            t0 = time.perf_counter()
            ev = eval_maskbit.main([
                f"config={gen_config}", f"eval.total_samples={sizes['eval_samples']}",
                f"eval.batch_size={sizes['eval_batch']}", f"eval.device={device}",
                "eval.shard_local_devices=true",
                "experiment.vqgan_checkpoint=", "experiment.generator_checkpoint=",
                f"experiment.output_dir={os.path.join(work, 'eval_maskbit')}"]
                + ([f"model.mlm_model.depth={sizes['eval_depth']}"] if sizes.get("eval_depth")
                   else []))
            wall = time.perf_counter() - t0
        finally:
            if saved is None:
                os.environ.pop("MASKBIT_INCEPTION_WEIGHTS", None)
            else:
                os.environ["MASKBIT_INCEPTION_WEIGHTS"] = saved
        batches = -(-sizes["eval_samples"] // sizes["eval_batch"])
        want = (sizes.get("eval_depth") or depth) * steps * batches
        counts = block_launches(made[-1].launch_counts()) if made else []
        log(f"[split] c. eval_maskbit over {len(devices)} entries: {ev['count']} of "
            f"{sizes['eval_samples']} samples scored in {batches} batches of "
            f"{sizes['eval_batch']}, IS {ev['results'].get('InceptionScore')}; wall {wall:.1f} s;"
            f" block launches per worker {counts} (expected {want} each); workers stopped "
            f"{bool(made) and _stopped(made[-1])}")
        if ev["count"] != sizes["eval_samples"] or ev["accumulator"].count != ev["count"]:
            raise AssertionError(f"eval_maskbit scored {ev['count']}")
        if len(made) != 1 or not _stopped(made[-1]) or (
                dev.type == "cuda" and counts != [want] * len(devices)):
            raise AssertionError(f"eval_maskbit's split: {len(made)} samplers, launches "
                                 f"{counts}, expected {want} each")
        out["eval"] = {"count": ev["count"], "wall_s": wall, "launches_per_replica": counts}
    finally:
        split.local_devices, split.make_sharded_sampler = real_local, real_make
        for sampler in made:
            sampler.close()

    try:
        # d. the native JPEG decoder
        prep = config.dataset.preprocessing
        out["decode"] = _decode_rates(work, sizes["decode_res"] or int(prep.get("resolution")),
                                      prep.get("interpolation", "bilinear"), stage2_step_s,
                                      sizes["photos"], sizes["decode_batch"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[split] phase time {out['seconds']:.1f} s")
    return out


def phase_split_scale(torch, device_info, gen_config=CONFIG, devices=None, sizes=None):
    """Phase 14: one sampler call split over 2, 4, ... distinct cards (a
    worker process a card) against the whole call on the first card, and
    against one call on the first card at a replica's share of the batch
    (the time a split would take were the replicas free of each other and
    of the transfers). Needs two visible cards or more; with one it says so
    and returns None."""
    from maskbit_tpu_torch.cli.common import load_generation_models
    from maskbit_tpu_torch.core.config import config_from_cli
    from maskbit_tpu_torch.sampling import serve as split
    from maskbit_tpu_torch.sampling.sample import make_sampler

    sizes = dict(SCALE_SIZES, **(sizes or {}))
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if len(devices) < 2:
        log("[scale] one card visible: the split over distinct cards is not timed here "
            "(`--phases split_scale` on a host with several cards)")
        return None
    t_phase = time.perf_counter()
    dev = devices[0]
    counts = [n for n in (2, 4, 8) if n < len(devices)] + [len(devices)]
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        log(f"[scale] cards: {'; '.join(smi.stdout.strip().splitlines())}")
    tok, gen, cfg, _, _ = load_generation_models(
        config_from_cli([f"config={gen_config}", "experiment.vqgan_checkpoint=",
                         "experiment.generator_checkpoint="]),
        logging.getLogger("chip_smoke.scale"), dev, cast_weights=True)
    n_tok = cfg.patch_size ** 2
    whole = make_sampler(gen, tok, cfg)

    def timed(fn):
        """The call's output and its wall seconds, once warm, `calls` times."""
        got, walls = fn(), []
        for _ in range(sizes["calls"]):
            for d in devices:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            got = fn()
            for d in devices:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
            walls.append(time.perf_counter() - t0)
        return got, walls

    out = {"cards": len(devices), "card": device_info["card"], "rows": []}
    inputs = {}
    for b in sizes["batches"]:
        g = torch.Generator(device=dev).manual_seed(b)
        shape = (cfg.num_steps, b, n_tok, cfg.codebook_splits)
        inputs[b] = (torch.arange(b, device=dev, dtype=torch.int64) * 97 % 1000,
                     (torch.randint(0, cfg.mask_token, shape, generator=g, device=dev,
                                    dtype=torch.int32),
                      -torch.log(torch.empty(shape, device=dev).exponential_(generator=g))))
    rows = {b: {"batch": b, "whole_s": None, "splits": []} for b in sizes["batches"]}
    for n in counts:
        t0 = time.perf_counter()
        with split.make_sharded_sampler(gen, tok, cfg, devices[:n]) as sampler:
            start_s = time.perf_counter() - t0
            for b in sizes["batches"]:
                if b % n:
                    continue
                labels, draws = inputs[b]
                per = b // n
                row = rows[b]
                if row["whole_s"] is None:
                    row["full"], row["whole_s"] = timed(lambda: whole(labels, injected=draws))
                share, share_s = timed(lambda: whole(labels[:per],
                                                     injected=tuple(d[:, :per] for d in draws)))
                sampler.launch_counts(reset=True)
                (images, tokens), split_s = timed(lambda: sampler(labels, injected=draws))
                launches = sampler.launch_counts()
                gap = (images[:per].float() - share[0].float()).abs().max().item()
                differ = int((tokens[:per] != share[1]).sum())
                agree = (tokens == row["full"][1]).float().mean().item()
                whole_s = row["whole_s"]
                log(f"[scale] batch {b} over {n} cards ({per} rows each, {n} worker processes "
                    f"started in {start_s:.2f} s): split {min(split_s):.3f} s "
                    f"({b / min(split_s):.3f} img/s), whole batch on one card {min(whole_s):.3f} s "
                    f"({b / min(whole_s):.3f} img/s), one card at {per} rows {min(share_s):.3f} s; "
                    f"speed-up {min(whole_s) / min(split_s):.3f} of {n} (ceiling "
                    f"{min(whole_s) / min(share_s):.3f}); first replica against the {per}-row "
                    f"call on {dev}: largest image gap {gap:.3e}, {differ} tokens differ; token "
                    f"agreement with the whole batch {agree:.4f} (no gate); block launches per "
                    f"worker over {1 + sizes['calls']} calls "
                    f"{[c['attention_block'] for c in launches]} [{device_info['card']}]")
                if gap != 0.0 or differ:
                    raise AssertionError(f"the first replica differs from the {per}-row call on "
                                         f"{dev}: gap {gap}, {differ} tokens")
                if not torch.isfinite(images.float()).all() or images.shape[0] != b:
                    raise AssertionError(f"split images {tuple(images.shape)} not finite")
                row["splits"].append({"cards": n, "split_s": split_s, "share_s": share_s,
                                      "start_s": start_s, "launches_per_worker": launches,
                                      "speedup": min(whole_s) / min(split_s),
                                      "ceiling": min(whole_s) / min(share_s),
                                      "whole_token_agreement": agree})
        if not _stopped(sampler):
            raise AssertionError(f"the {n}-card split's workers outlived it")
    for b in sizes["batches"]:
        rows[b].pop("full", None)
        out["rows"].append(rows[b])
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[scale] phase time {out['seconds']:.1f} s")
    return out


# phase 15: four ranks, a card each, over NCCL. Stage II's stop run (per-rank
# batch 32, full depth, from 2048 random token shards' tokens); fsdp=2 x
# tensor=2 at 16 rows a batch shard (global 32, the same rows on the two
# ranks of a tensor pair, 8 heads each) for `sh_steps` injected steps, then
# `sample` labels sampled with the whole EMA weights; the combined ranks'
# data=4 gradient check at 16 a rank (global 64), Stage I at 16 a rank
# across the gate, `eval_maskbit` on 1000 samples at batch 100; each
# launch's limit (s). The fsdp x tensor first update is held to
# DP_GRAD_TOL: as at data=2, the ranks' GEMMs see other shapes than one
# process's (bf16 tiles, other summation orders), and a tensor rank rounds
# its partial out-projection and fc2 products to bf16 before their sum,
# which `parallel/mesh._staged` then takes in float32 under NCCL as under
# gloo: a few 1e-3 are expected (tensor=2 on two gloo ranks of one card:
# 3.701e-03, PERF.md).
MC_WORLD = 4
MC_SIZES = {"batch": 32, "depth": 24, "tokens": 2048, "sh_batch": 16, "sh_steps": 6,
            "sample": 2, "grad_batch": 16, "tok_batch": 16, "tok_steps": 4, "tok_gate": 2,
            "eval_samples": 1000, "eval_batch": 100, "timeout": 420}


def phase_multicard(torch, device_info, device="cuda", gen_config=CONFIG,
                    tok_config=TOKENIZER_CONFIGS[0], sizes=None) -> dict:
    """Phase 15: the port over four cards of one host, one process (rank)
    a card, NCCL between them: Stage II at data=4 through `cli.train_maskbit`
    (a SIGTERM stop and a resume), at fsdp=2 x tensor=2 (the first update
    against one process, the collectives timed, with and without half types
    widened), Stage I at data=4 across the gate, and `cli.eval_maskbit`
    over the four ranks. Each part runs even when another failed; the phase
    fails if any did. Needs four visible cards (with fewer it says so and
    returns None); device="cpu" with tiny configs and `sizes` rehearses it
    on four gloo ranks (launches and backends are then not checked), e.g.
    a 16 px generator with 2 heads, `attention_dropout: 0.1` and
    `fused_attention_dropout: true`, a 32 px tokenizer with a
    discriminator node, and sizes={"batch": 2, "depth": 2, "tokens": 256,
    "sh_batch": 2, "sh_steps": 4, "sample": 2, "grad_batch": 2,
    "tok_batch": 2, "tok_steps": 3, "tok_gate": 1, "eval_samples": 8,
    "eval_batch": 2, "tok_res": 32, "timeout": 300} (about 145 s on 8
    cores)."""
    import traceback

    import maskbit_tpu_torch
    from maskbit_tpu_torch.eval import inception as inc
    from maskbit_tpu_torch.parallel.mesh import BUCKET_BYTES

    s = dict(MC_SIZES, **(sizes or {}))
    cuda = device == "cuda"
    world = MC_WORLD
    if cuda and torch.cuda.device_count() < world:
        log(f"[multicard] {torch.cuda.device_count()} card(s) visible: not run "
            f"(`--phases multicard` on a host with {world} cards)")
        return None
    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_multicard")  # git-ignored; ~10 GB
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    if cuda:
        torch.cuda.empty_cache()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        log(f"[multicard] cards: {'; '.join(smi.stdout.strip().splitlines())}")
    card = device_info["card"]
    tree = os.path.dirname(os.path.dirname(os.path.abspath(maskbit_tpu_torch.__file__)))
    base = {"tree": tree, "device": device, "work": work}
    mlm = _model_node(gen_config)["mlm_model"]
    heads, sampling_steps = int(mlm["heads"]), int(mlm["num_steps"])
    out, failed = {}, {}

    def backends(ranks, what):
        got = [r["backend"] for r in ranks]
        log(f"[multicard] {what}: backend per rank {got}")
        if cuda and set(got) != {"nccl"}:
            raise AssertionError(f"{what} ran on {got}, not NCCL")

    def part(name, fn):
        try:
            out[name] = fn()
        except Exception as e:  # noqa: BLE001 — every part runs; the phase fails below
            failed[name] = f"{e!r}"
            log(f"[multicard] {name} FAILED:\n{traceback.format_exc()}")

    try:
        # the group forms, and one gradient bucket's all-reduce, before the rest
        procs = _spawn_ranks(dict(base, task="handshake", tag="mc_handshake"), world)
        _wait_ranks(procs, "mc_handshake", min(s["timeout"], 180))
        shake = _rank_results(work, "mc_handshake", world)
        mb = BUCKET_BYTES / 2**20
        for r in shake:
            log(f"[multicard] rank on {r['card']} ({r['backend']}): all-reduce mean of a "
                f"{mb:.0f} MiB float32 bucket {[round(x, 5) for x in r['bucket_s']]} s, mean "
                f"right {r['mean_ok']} [{card}]")
        backends(shake, "the group")
        if not all(r["mean_ok"] for r in shake):
            raise AssertionError(f"the bucket's mean is wrong: {shake}")
        out["handshake"] = shake

        # a. Stage II at data=4 through the CLI: a SIGTERM stop, a resume
        common = [f"config={gen_config}", f"training.device={device}",
                  "dataset.params.token_shards_path_or_url="
                  + _token_shards(work, gen_config, s["tokens"]),
                  "experiment.vqgan_checkpoint=", "experiment.log_every=1",
                  "experiment.generate_every=100000", "experiment.eval_every=100000"]

        def stage2():
            got = _stop_and_resume(base, common, world, s["batch"], s["depth"],
                                   os.path.join(work, "train"), s["timeout"], cuda, card,
                                   "mc_stage2", "multicard a.")
            backends(got["ranks"] + got["resume"], "a. Stage II at data=4")
            return got

        part("stage2", stage2)

        # c. data=4: the gradient check, Stage I across the gate, eval_maskbit
        weights = os.path.join(work, "pt_inception.pth")
        torch.save(inc.random_inception_state(0), weights)
        resnet = os.path.join(work, "resnet50.pth")
        _random_resnet50(torch, resnet)
        sc = dict(s, batch=s["grad_batch"], grad_depth=s["depth"])
        spec_c = _combined_spec(base, work, gen_config, tok_config, device, sc, world)

        def combined():
            procs = _spawn_ranks(spec_c, world, env={
                "MASKBIT_INCEPTION_WEIGHTS": weights, "MASKBIT_ADM_PB": "",
                "MASKBIT_RESNET50_WEIGHTS": resnet})
            try:
                reference = _reference_step(torch, spec_c, cuda)  # one process, meanwhile
            finally:
                _wait_ranks(procs, "combined", s["timeout"])
            got = _check_combined(torch, spec_c, sc, world, reference, cuda, card,
                                  "multicard c.")
            backends(got["ranks"], "c. data=4 gradients, Stage I, eval_maskbit")
            return got

        part("combined", combined)

        # b. fsdp=2 x tensor=2: the first update against one process
        spec_b = dict(base, task="sharded", tag="mc_sharded", mesh={"fsdp": 2, "tensor": 2},
                      gen_config=gen_config, grad_depth=s["depth"],
                      global_batch=2 * s["sh_batch"], steps=s["sh_steps"], sample=s["sample"],
                      res=int(mlm.get("img_size", 256)), save=False, half_steps=(2, 4))

        def sharded():
            procs = _spawn_ranks(spec_b, world)
            try:
                reference = _reference_step(torch, spec_b, cuda)  # one process, meanwhile
            finally:
                _wait_ranks(procs, spec_b["tag"], s["timeout"])
            ranks = _rank_results(work, spec_b["tag"], world)
            got = _check_sharded_steps(torch, spec_b, ranks, reference, s["sh_steps"], heads,
                                       cuda, card, "multicard b. fsdp=2 x tensor=2")
            backends(ranks, "b. fsdp=2 x tensor=2")
            want = s["depth"] * sampling_steps
            for r in ranks:
                log(f"[multicard] b. rank {r['coords']}: {s['sample']} samples with the whole "
                    f"EMA weights in {r['sample_s']:.2f} s, launches {r['sample_launches']} at "
                    f"{r['block_heads']} heads; finite {r['sample_finite']}; tensor-local again "
                    f"{r['restored_tensor_local']}")
                if not (r["sample_finite"] and r["restored_tensor_local"]) or (
                        r["block_heads"] != [heads]) or (
                        cuda and any(v != want for v in r["sample_launches"].values())):
                    raise AssertionError(f"fsdp=2 x tensor=2 generation: {r}")
            dp = out.get("combined", {}).get("ranks")
            if dp:
                log(f"[multicard] b. state per rank {[r['state_bytes'] for r in ranks]} B, peak "
                    f"{[r['peak_bytes'] for r in ranks]} B; data=4 at the same rows a rank "
                    f"(c.): state {[r['state_bytes'] for r in dp]} B, peak "
                    f"{[r['peak_bytes'] for r in dp]} B [{card}]")
            for r in ranks:  # step 2 and the later steps not in half_steps: widened
                steps = [dict(r["comm_s"], half=False)] + list(r["comm_by_step"].values())
                mean = {h: statistics.mean(c.get("tensor_all_reduce", 0.0) for c in steps
                                           if c["half"] == h) for h in (False, True)}
                log(f"[multicard] b. rank {r['coords']}: the tensor all-reduces of a step, "
                    f"mean over {sum(not c['half'] for c in steps)} steps with half types in "
                    f"float32 {mean[False]:.4f} s, over {sum(c['half'] for c in steps)} left "
                    f"in half {mean[True]:.4f} s [{card}]")
                r["tensor_all_reduce_mean_s"] = {"float32": mean[False], "half": mean[True]}
            return got

        part("sharded", sharded)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[multicard] phase time {out['seconds']:.1f} s")
    if failed:
        raise AssertionError(f"[multicard] parts failed: {failed}")
    return out


# phase 16's run `flagship` at the flagship's width, its depth cut from 24 to
# make room for phase 17, then to 6 for phase 18
SYSTEM_CHECK_FLAGSHIP_DEPTH = 6


def phase_system_check(torch) -> dict:
    """Phase 16: both runs of `cli.system_check` on the card; its own
    thresholds fail the phase. The launches are counted per run, zeroed
    just before its Stage II and read after its sampling."""
    from maskbit_tpu_torch.cli import system_check

    t0 = time.perf_counter()
    result = system_check.run_check("cuda", log=lambda m: log(f"[system-check] {m}"),
                                    flagship_depth=SYSTEM_CHECK_FLAGSHIP_DEPTH)
    tok = result["tokenizer"]
    for name, r in result["runs"].items():
        launched = {**r["launches_train"]["by_head_dim"], **r["launches_sample"]["by_head_dim"],
                    "attention_block": r["launches_sample"]["attention_block"]}
        log(f"[system-check] run {name} (head dim {r['head_dim']}, depth {r['depth']}): recon "
            f"{tok['recon_first']:.4f} -> {tok['recon_last']:.4f} (Stage I {tok['stage1_seconds']:.1f}"
            f" s); mlm loss {r['mlm_loss']:.4f}, masked acc {r['masked_acc']:.4f} (Stage II "
            f"{r['stage2_seconds']:.1f} s); quadrant MSE matched {r['matched']:.5f} chance "
            f"{r['chance']:.5f} (ratio {r['matched'] / r['chance']:.3f}; sampling "
            f"{r['sample_seconds']:.1f} s); launches {launched}")
        for key in ("dropout_attention_fwd", "dropout_attention_bwd"):
            if r["launches_train"]["by_head_dim"].get(f"{key}@{r['head_dim']}", 0) <= 0:
                raise AssertionError(f"run {name}: no {key} launch at head dim {r['head_dim']}")
        if r["launches_sample"]["by_head_dim"].get(f"fused_attention@{r['head_dim']}", 0) <= 0:
            raise AssertionError(f"run {name}: no block launch at head dim {r['head_dim']}")
    result["seconds"] = time.perf_counter() - t0
    return result


# Phase 17, the float32 forms of the four kernels (`csrc/attention_f32.cu`).
# A kernel and its plain version both compute in full float32 (TF32 off) on
# the same inputs and differ only in summation order and exp2f against exp:
# a few ulp of each sum, far below 1e-4 of the largest reference value (or
# 1e-4 absolute below 1).
F32_TOL = 1e-4
PEAK_F32_FLOPS = 67e12  # H100 SXM data sheet: float32 on the CUDA cores
PEAK_TF32_FLOPS = 495e12  # and TF32 on the tensor cores, dense
# the depth-2 float32 step on the card against the CPU's float32 step: both
# in float32, summed in other orders over 2 layers and a 16,384-way cross
# entropy (a few 1e-6 relative); the loss within 1e-4, the global grad norm
# (a sum of squares over every parameter) within 1e-3
F32_STEP_TOL = {"mlm_loss": 1e-4, "grad_norm": 1e-3}
# the float32 train CLI's steps and its in-training generations
F32_TRAIN_STEPS, F32_GENERATE_EVERY = 4, 3
# the head dims whose float32 kernels are timed: the flagship's and the
# other widths' timed ones, past 128 too
F32_TIMED_HEAD_DIMS = (32, 64, 128, *WIDE_TIMED_HEAD_DIMS)
# the CUDA kernels of each float32 row (csrc/attention_f32.cu, layernorm.cuh)
F32_CUDA_KERNELS = {
    "fused_attention_block": ["split_tf32_kernel", "proj_tf32_kernel<0>",
                              "attn_fwd_tf32_kernel<D, false>", "proj_tf32_kernel<1>",
                              "layernorm_kernel<float>"],
    "dropout_attention_fwd": ["attn_fwd_tf32_kernel<D, true>"],
    "dropout_attention_bwd": ["attn_bwd_prep_f32_kernel<D>", "attn_bwd_tf32_kernel<D>"],
    "fused_attention": ["attn_fwd_tf32_kernel<D, false>"]}


def _bound_f32(flops: float, nbytes: float) -> dict:
    """A float32 function's bound both ways: `bound_ms`, the least time the
    card could take, with its products as 3xTF32 on the tensor cores (three
    TF32 products each, at the TF32 peak), and `bound_ffma_ms`, with them
    as FFMA on the CUDA cores (the float32 peak); each against the bytes."""
    tc, ffma = _bound(3 * flops, nbytes, PEAK_TF32_FLOPS), _bound(flops, nbytes, PEAK_F32_FLOPS)
    return {**tc, "bound_ffma_ms": ffma["bound_ms"], "bound_ffma_by": ffma["bound_by"]}


def _f32_shapes(d: int) -> tuple:
    """(heads, the dropout pair's batch, the block's and fused_attention's
    batch, the block's E) at head dim d: the flagship's at 64, else phase
    3's `HEAD_DIM_SHAPES`."""
    return (HEADS, TRAIN_BATCH, 2 * SERVE_BATCH, 1024) if d == 64 else HEAD_DIM_SHAPES[d]


def phase_float32_kernels(torch) -> dict:
    """The four kernels' float32 forms against their plain versions in
    float32 (TF32 off) at every head dim of the templates and at the timed
    ones past 128, n = 257 and 17 (`WIDTH_LENGTHS`), the keep mask bit for
    bit; timed at n =
    257 at `F32_TIMED_HEAD_DIMS` beside SDPA (the block beside the library
    chain) and the float32 bound; past 128 the CUDA kernels one call of each
    launches at n = 257 (`kernels`, which the final record holds to
    `WIDE_CUDA_KERNELS`); the padded head dims and `WIDE_SHAPES` checked;
    float16 and float64 refused."""
    from maskbit_tpu_torch.nn import attention_block as ab
    from maskbit_tpu_torch.nn import dropout_attention as da

    f32 = torch.float32
    rows, timed = [], {}
    for d in (*da.HEAD_DIMS, *WIDE_TIMED_HEAD_DIMS):
        h, b, bb, e = _f32_shapes(d)
        for n in WIDTH_LENGTHS[d > 128]:
            q, k, v = _qkv_packed(torch, b, n, h, seed=d * n + 3, d=d, dtype=f32)
            seeds = torch.randint(0, 2**32, (b, h), device="cuda", dtype=torch.int64,
                                  generator=torch.Generator(device="cuda").manual_seed(d + n + 1))
            seeds32 = da.seeds_as_int32(seeds, (b, h))
            g = torch.randn(b, n, h, d, generator=torch.Generator(device="cuda").manual_seed(n + 2),
                            device="cuda")
            out, lse = da.launch_forward(q, k, v, seeds32, RATE)
            grads = da.launch_backward(q, k, v, out, lse, g, seeds32, RATE)
            fq, fk, fv = _qkv_packed(torch, bb, n, h, seed=d * n + 4, d=d, dtype=f32)
            fused = da.fused_attention(fq, fk, fv)
            inp = _block_inputs(torch, bb, n, e, seed=d * n + 5, vectors=f32, dtype=f32)
            block = ab.fused_attention_block(**inp, num_heads=e // d)
            torch.cuda.synchronize()
            pairs = {"fwd": (out, da.dropout_attention_reference(q, k, v, seeds, RATE)),
                     **dict(zip(("dq", "dk", "dv"), zip(grads, da.dropout_attention_backward_reference(
                         q, k, v, g, seeds, RATE)))),
                     "fused": (fused, da.fused_attention_reference(fq, fk, fv)),
                     "block": (block, ab.fused_attention_block_reference(**inp, num_heads=e // d))}
            errs, tols = {}, {}
            for key, (got, ref) in pairs.items():
                if got.dtype != f32 or not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"float32 {key} at head dim {d}, n {n}: {got.dtype}, "
                                         "or not finite")
                errs[key] = (got - ref).abs().max().item()
                tols[key] = F32_TOL * max(1.0, ref.abs().max().item())
            mask_flips = int((kernel_keep_mask(torch, da, seeds, b, n, h, d, dtype=f32)
                              != da.hash_keep_mask(seeds, n, RATE)).sum().item())
            row = dict(d=d, n=n, heads=h, dropout_shape=[b, n, h, d], fused_shape=[bb, n, h, d],
                       block_shape=[bb, n, e], errs=errs, tols=tols, mask_flips=mask_flips)
            log(f"[float32] head dim {d}, n {n}: dropout ({b}, {n}, {h}, {d}), fused_attention "
                f"({bb}, {n}, {h}, {d}), block ({bb}, {n}, {e}): max_abs_err " + ", ".join(
                    f"{key} {errs[key]:.3e} (tol {tols[key]:.1e})" for key in errs)
                + f"; keep mask {mask_flips} of {b * h * n * n} bits differ")
            if mask_flips or any(errs[key] > tols[key] for key in errs):
                raise AssertionError(f"the float32 kernels disagree at head dim {d}, n {n}: {row}")
            if n == 257 and d > 128:  # the CUDA kernels one call of each launches
                calls = {"dropout_attention_fwd": lambda: da.launch_forward(q, k, v, seeds32, RATE),
                         "dropout_attention_bwd": lambda: da.launch_backward(
                             q, k, v, out, lse, g, seeds32, RATE),
                         "fused_attention": lambda: da.fused_attention(fq, fk, fv),
                         "fused_attention_block": lambda: ab.fused_attention_block(
                             **inp, num_heads=e // d)}
                row["kernels"] = {name: sorted({_kernel_name(x) for x in _device_breakdown(
                    torch, fn, iters=5, warmup=1)}) for name, fn in calls.items()}
                log(f"[float32]   head dim {d} CUDA kernels: " + "; ".join(
                    f"{name} {', '.join(ks)}" for name, ks in row["kernels"].items()))
            if n == 257 and d in F32_TIMED_HEAD_DIMS:
                elems = b * n * h * d
                lib_g = g.transpose(1, 2)
                ql, kl, vl = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
                lib_out = _sdpa(torch, ql, kl, vl, RATE)
                t = {"dropout_attention_fwd": dict(
                    **_times(torch, lambda: da.launch_forward(q, k, v, seeds32, RATE),
                             plain=lambda: da.dropout_attention_reference(q, k, v, seeds, RATE),
                             library=lambda: _sdpa(torch, q, k, v, RATE)),
                    shape=[b, n, h, d],
                    **_bound_f32(4 * b * h * n * n * d, 4 * 4 * elems + 4 * b * h * n)),
                    "dropout_attention_bwd": dict(
                    **_times(torch, lambda: da.launch_backward(q, k, v, out, lse, g, seeds32, RATE),
                             plain=lambda: da.dropout_attention_backward_reference(
                                 q, k, v, g, seeds, RATE),
                             library=lambda: torch.autograd.grad(lib_out, (ql, kl, vl), lib_g,
                                                                 retain_graph=True)),
                    shape=[b, n, h, d],
                    **_bound_f32(10 * b * h * n * n * d, 4 * 8 * elems + 4 * b * h * n)),
                    "fused_attention": dict(
                    **_times(torch, lambda: da.fused_attention(fq, fk, fv),
                             plain=lambda: da.fused_attention_reference(fq, fk, fv),
                             library=lambda: _sdpa(torch, fq, fk, fv, 0.0)),
                    shape=[bb, n, h, d],
                    **_bound_f32(4 * bb * h * n * n * d, 4 * 4 * bb * n * h * d))}
                call = lambda: ab.fused_attention_block(**inp, num_heads=e // d)  # noqa: E731
                chain = {_kernel_name(key): ms for key, ms in _device_breakdown(torch, call).items()}
                t["fused_attention_block"] = dict(
                    ms=sum(chain.values()), call_ms=_time_ms(torch, call),
                    plain_ms=_device_ms(torch, lambda: ab.fused_attention_block_reference(
                        **inp, num_heads=e // d)),
                    shape=[bb, n, e], chain=chain,
                    library_chain_ms=_device_ms(torch, _library_chain(torch, inp, e // d)),
                    **_bound_f32(2 * bb * n * e * 3 * e + 2 * bb * n * e * e
                                 + 4 * bb * (e // d) * n * n * d,
                                 4 * (2 * bb * n * e + 4 * e * e) + 4 * 6 * e))
                log(f"[float32]   head dim {d} device ms (per call by events; plain; library; "
                    f"bound as 3xTF32; bound as FFMA): " + "; ".join(
                        f"{name} {x['ms']:.4f} ({x['call_ms']:.4f}; {x['plain_ms']:.4f}; "
                        f"{x.get('library_ms', x.get('library_chain_ms')):.4f}; "
                        f"{x['bound_ms']:.4f} by {x['bound_by']}; {x['bound_ffma_ms']:.4f} by "
                        f"{x['bound_ffma_by']})" for name, x in t.items()))
                log("[float32]   block chain, device ms per call: " + "; ".join(
                    f"{key} {ms:.4f}" for key, ms in chain.items()))
                timed[d] = t
                del lib_out, ql, kl, vl
            rows.append(row)
            del q, k, v, g, out, lse, grads, fq, fk, fv, fused, inp, block, pairs
    # head dims that are not multiples of 16, and widths E that are not
    # multiples of 64 or exceed 4096, zero-padded by the wrappers
    padded = [_padded_check(torch, d, n, shapes, f32)
              for d, shapes in PADDED_SHAPES.items() for n in (257, 17)]
    padded += [_padded_block_check(torch, b, n, e, heads, f32)
               for b, n, e, heads in PADDED_BLOCKS]
    wide = [_padded_check(torch, d, n, shapes, f32)
            for d, shapes in WIDE_SHAPES.items() for n in (257, 17)]
    # dtypes JAX's resolve_compute_dtype never yields raise, on the card
    refused = []
    for dt in (torch.float16, torch.float64):
        q, k, v = _qkv_packed(torch, 1, 17, 2, seed=1, d=64, dtype=dt)
        inp = {key: (x.to(dt) if x.dim() > 1 else x) for key, x in _block_inputs(
            torch, 1, 17, 128, seed=1, vectors=f32, dtype=f32).items()}
        for name, fn in (("dropout_attention", lambda: da.dropout_attention(
                             q, k, v, torch.zeros(1, 2, dtype=torch.int64), RATE)),
                         ("fused_attention", lambda: da.fused_attention(q, k, v)),
                         ("fused_attention_block", lambda: ab.fused_attention_block(
                             **inp, num_heads=2))):
            try:
                fn()
            except TypeError as err:
                refused.append(f"{name} {dt}: {err}")
            else:
                raise AssertionError(f"{name} ran on {dt}")
    log("[float32] refused: " + "; ".join(refused))
    return {"rows": rows, "timed": timed, "padded": padded, "wide": wide, "refused": refused,
            "ptxas": _tf32_ptxas()}


def _tf32_ptxas() -> list:
    """ptxas's registers and spill bytes of the 3xTF32 kernels (the float32
    forward and backward, the block's projections and weight split),
    logged."""
    from maskbit_tpu_torch.nn import cuda_build

    rows = [k for k in ptxas_kernels(cuda_build.build_log["attention_f32"]["ptxas"])
            if "tf32" in k["kernel"]]
    for k in rows:
        log(f"[float32] ptxas {k['kernel']}: {k['registers']} registers, spill stores "
            f"{k['spill_stores']} B, spill loads {k['spill_loads']} B")
    return rows


def _only(launched: dict, want: dict, what: str) -> None:
    """Raises unless `launched` holds exactly `want` (one dtype's kernels at
    one head dim)."""
    if launched != want:
        raise AssertionError(f"{what}: launches {launched}, expected {want} (nothing else)")


def _f32_profile_check(torch) -> dict:
    """A profile of one float32 block call, one float32 serving-mode
    BertAttention call and one float32 dropout-attention forward and
    backward through autograd: each launches its float32 kernels and no
    library GEMM or attention kernel (nor a bf16 one of the port)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from maskbit_tpu_torch.nn import attention_block as ab
    from maskbit_tpu_torch.nn import dropout_attention as da
    from maskbit_tpu_torch.nn.transformer import BertAttention

    f32 = torch.float32
    inp = _block_inputs(torch, 2 * SERVE_BATCH, 257, 1024, seed=7, vectors=f32, dtype=f32)
    layer = BertAttention(1024, HEADS, attention_impl="fused").cuda().eval()
    with torch.no_grad():
        for param in layer.parameters():
            param.normal_(0.0, 0.02, generator=torch.Generator(device="cuda").manual_seed(11))
    q, k, v = (x.detach().clone().requires_grad_(True) for x in _qkv_packed(
        torch, TRAIN_BATCH, 257, HEADS, seed=8, dtype=f32))
    seeds = torch.randint(0, 2**32, (TRAIN_BATCH, HEADS), device="cuda", dtype=torch.int64,
                          generator=torch.Generator(device="cuda").manual_seed(9))
    g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(10),
                    device="cuda")
    block_kernels = ("split_tf32_kernel", "proj_tf32_kernel<0>", "attn_fwd_tf32_kernel",
                     "proj_tf32_kernel<1>", "layernorm_kernel<float>")
    calls = {"block": (lambda: ab.fused_attention_block(**inp, num_heads=HEADS), block_kernels),
             "bert_attention": (lambda: layer(inp["x"]), block_kernels),
             "dropout_attention": (lambda: torch.autograd.grad(
                 da.dropout_attention(q, k, v, seeds, RATE), (q, k, v), g),
                 ("attn_fwd_tf32_kernel", "attn_bwd_prep_f32_kernel", "attn_bwd_tf32_kernel"))}
    banned = ("gemm", "nvjet", "cutlass", "flash", "cudnn", "fmha", "efficient_attention",
              "softmax", "attn_fwd_kernel", "attn_bwd_kernel", "proj_kernel<",
              "layernorm_kernel<__nv")
    seen = {}
    for name, (call, own) in calls.items():
        # each call launches every one of `own`: a profile of 20 calls that
        # lacks one lost events (CUPTI sometimes records nothing of a
        # short profile) and is taken again, at most
        # `tries` times; a kernel not allowed fails at once
        tries = 3
        for attempt in range(tries):
            with torch.inference_mode(name != "dropout_attention"):
                call()  # warm
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        call()
                    torch.cuda.synchronize()
            names = [_kernel_name(ev.key) for ev in prof.key_averages()
                     if ev.device_type == DeviceType.CUDA]
            missing = [x for x in own if not any(x in key for key in names)]
            bad = [key for key in names if any(x in key.lower() for x in banned)]
            if name != "dropout_attention":  # the block launches its own kernels and nothing else
                bad += [key for key in names if not any(x in key for x in own)]
            log(f"[float32] profile of one {name} call (try {attempt + 1}): {names}")
            if bad or not missing:
                break
        seen[name] = names
        if missing or bad:
            raise AssertionError(f"float32 {name}: kernels {missing} missing, {bad} not allowed")
    return seen


def _cli_train(torch, device_info, precision: str = "no", heads: int = HEADS,
               generate_every: int = F32_GENERATE_EVERY, tag: str = "float32") -> dict:
    """`cli.train_maskbit.main` on the flagship config at
    `training.mixed_precision=<precision>` and `model.mlm_model.heads=<heads>`,
    batch 32, `F32_TRAIN_STEPS` steps with in-training generation every
    `generate_every` (the EMA sample grid through the block): finite
    losses, the grids, and that dtype's kernels at d = hidden / heads only,
    on every layer of every step and sampling step."""
    import numpy as np

    from maskbit_tpu_torch.cli.train_maskbit import main
    from maskbit_tpu_torch.nn import attention_block as ab

    mlm = _flagship()["mlm_model"]
    depth, sampling_steps = int(mlm["depth"]), int(mlm["num_steps"])
    at = f"@{int(mlm['hidden_dim']) // heads}/{'float32' if precision == 'no' else 'bfloat16'}"
    out_dir = os.path.join(ROOT, "build", "chip_smoke_f32_train")  # git-ignored
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = [f"config={CONFIG}", f"training.per_device_batch_size={TRAIN_BATCH}",
            f"training.max_train_steps={F32_TRAIN_STEPS}", "training.device=cuda",
            f"training.mixed_precision={precision}", f"model.mlm_model.heads={heads}",
            "experiment.vqgan_checkpoint=", "experiment.log_every=1",
            f"experiment.generate_every={generate_every}",
            "experiment.save_every=100000", "experiment.eval_every=100000",
            f"experiment.output_dir={out_dir}"]
    ab.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = main(argv)
    wall = time.perf_counter() - t0
    launched = ab.launch_counts()["by_dtype"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    hist = result["history"]
    losses = [h["mlm_loss"] for h in hist]
    step_s = [h["perf/step_seconds"] for h in hist]
    image_dir = os.path.join(out_dir, "images")
    grids = sorted(os.listdir(image_dir)) if os.path.isdir(image_dir) else []
    n_gen = F32_TRAIN_STEPS // generate_every
    sampled = depth * sampling_steps * n_gen
    want = {f"dropout_attention_fwd{at}": depth * F32_TRAIN_STEPS,
            f"dropout_attention_bwd{at}": depth * F32_TRAIN_STEPS}
    if sampled:
        want.update({f"attention_block{at}": sampled, f"fused_attention{at}": sampled})
    median_s = statistics.median(step_s[1:])
    log(f"[{tag}] train_maskbit mixed_precision={precision}, heads {heads}, batch {TRAIN_BATCH}, "
        f"depth {depth}: losses {', '.join(f'{x:.4f}' for x in losses)}; step seconds "
        f"{', '.join(f'{x:.4f}' for x in step_s)} (median of steps 2..{len(hist)} "
        f"{median_s * 1e3:.1f} ms = {TRAIN_BATCH / median_s:.1f} samples/s, generation steps "
        f"included); peak memory {peak_gib:.2f} GiB; wall {wall:.1f} s; grids {grids}; "
        f"launches {launched} [{device_info['card']}]")
    want_grids = [f"train_{kind}-{s:09d}.png" for kind in ("decoded", "generated")
                  for s in range(generate_every, F32_TRAIN_STEPS + 1, generate_every)]
    if len(losses) != F32_TRAIN_STEPS or not all(np.isfinite(losses)) or grids != want_grids:
        raise AssertionError(f"{tag} train CLI: losses {losses}, grids {grids}")
    _only(launched, want, f"{tag} train CLI")
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"launches": launched, "losses": losses, "step_seconds": step_s,
            "median_step_s": median_s, "peak_gib": peak_gib, "wall_s": wall}


def _cli_serve(torch, device_info, precision: str = "no", heads: int = HEADS,
               tag: str = "float32") -> dict:
    """`cli.serve` on the flagship at `training.mixed_precision=<precision>`
    and `model.mlm_model.heads=<heads>`: one seeded /generate of
    `SERVE_BATCH` labels (64 steps, CFG), the block in that dtype at d =
    hidden / heads on every layer of every step of both device calls (the
    warm-up and the request)."""
    from maskbit_tpu_torch.cli.serve import main
    from maskbit_tpu_torch.nn import attention_block as ab

    mlm = _flagship()["mlm_model"]
    depth, steps = int(mlm["depth"]), int(mlm["num_steps"])
    at = f"@{int(mlm['hidden_dim']) // heads}/{'float32' if precision == 'no' else 'bfloat16'}"
    argv = [f"config={CONFIG}", f"serve.batch_size={SERVE_BATCH}", "serve.port=0",
            "serve.device=cuda", "serve.shard_local_devices=false",
            f"training.mixed_precision={precision}", f"model.mlm_model.heads={heads}",
            "experiment.vqgan_checkpoint=", "experiment.generator_checkpoint="]
    ab.reset_launch_counts()
    t0 = time.perf_counter()
    server, service = main(argv, serve_forever=False)
    startup = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        labels = list(range(1, 8 * SERVE_BATCH, 8))[:SERVE_BATCH]
        data, request_s = _post(base, {"labels": labels, "seed": 3})
        images = _images(data)
        _check_images(images, SERVE_BATCH)
        calls = service.device_calls
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    torch.cuda.synchronize()
    launched = ab.launch_counts()["by_dtype"]
    want = {f"attention_block{at}": depth * steps * calls,
            f"fused_attention{at}": depth * steps * calls}
    log(f"[{tag}] serve mixed_precision={precision}, heads {heads}: startup (random init + "
        f"warm-up call) {startup:.2f} s; a seeded {SERVE_BATCH}-label /generate {request_s:.3f} "
        f"s = {SERVE_BATCH / request_s:.3f} img/s; device calls {calls}; launches {launched} "
        f"[{device_info['card']}]")
    _only(launched, want, f"{tag} serve")
    return {"launches": launched, "request_s": request_s, "img_per_s": SERVE_BATCH / request_s,
            "startup_s": startup}


def phase_float32(torch, device_info) -> dict:
    """Phase 17: the float32 kernels against their plain versions and
    timed; the profile check; the depth-2 float32 step against the CPU's;
    the train CLI and the server at `training.mixed_precision=no`, each
    with its launch counts zeroed just before it."""
    kernels = phase_float32_kernels(torch)
    profiled = _f32_profile_check(torch)
    check = phase_train_check(torch, torch.float32, F32_STEP_TOL)
    train = _cli_train(torch, device_info)
    serve = _cli_serve(torch, device_info)
    return {"kernels": kernels, "profile": profiled, "train_check": check, "train": train,
            "serve": serve}


# Phase 18: the flagship at model.mlm_model.heads=4 (hidden 1024 over 4
# heads of 256, past the narrow kernel templates: csrc/attention_wide_bf16.cuh's
# kernels in bf16, csrc/attention_wide_f32.cuh's in float32), no in-training
# generation
WIDE_HEADS = 4


def phase_wide_heads(torch, device_info) -> dict:
    """Phase 18: one seeded sampler call (`cli.serve`, batch 8, as phase 17)
    and `F32_TRAIN_STEPS` Stage-II steps (`cli.train_maskbit`, batch 32) of
    the flagship at `model.mlm_model.heads=4` (d = 256), in bf16 and in
    float32, each with its launch counts zeroed just before it and read
    just after: only the four kernels at d = 256 of its dtype."""
    out = {}
    for precision, dt in (("bf16", "bfloat16"), ("no", "float32")):
        out[dt] = {"serve": _cli_serve(torch, device_info, precision, WIDE_HEADS,
                                       tag=f"wide {dt}"),
                   "train": _cli_train(torch, device_info, precision, WIDE_HEADS,
                                       generate_every=10**6, tag=f"wide {dt}")}
    return out


# the float32 error probe's contraction lengths: the block's E (its
# projections sum over E; d = 64) and the backward's n (dK and dV sum over
# the queries, dQ over the keys; (1, n, 4, 64))
F32_ERROR_E = (1024, 2048, 4096, 4608, 8192)
F32_ERROR_N = (257, 1025, 4097)
# and past head dim 128: the panelled kernels at d = 256, n = 257
F32_ERROR_WIDE_D = 256


def _block_f64(torch, inp, heads):
    """The postnorm block in float64 throughout, as the float64 yardstick."""
    f64 = torch.float64
    x = inp["x"].to(f64)
    b, n, e = x.shape
    d = e // heads
    qkv = x @ inp["wqkv"].to(f64) + inp["bqkv"].to(f64)
    q, k, v = qkv.view(b, n, 3, heads, d).unbind(2)
    w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * d**-0.5, dim=-1)
    y = x + torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, n, e) @ inp["wo"].to(f64)
    y = y + inp["bo"].to(f64)
    return torch.nn.functional.layer_norm(y, (e,), inp["ln_scale"].to(f64),
                                          inp["ln_bias"].to(f64), eps=1e-12)


def _lse(torch, q, k):
    """The rows' log-sum-exp of the scores (b*h, n), in q's dtype."""
    b, n, h, d = q.shape
    return torch.logsumexp(torch.einsum("bqhd,bkhd->bhqk", q, k) * d**-0.5, -1).reshape(b * h, n)


def phase_f32_error(torch) -> dict:
    """Not in the default run (`--phases f32_error`, with `--tree` to
    compare trees): the float32 kernels' error against float64 as the
    contraction grows, beside the plain float32 version's (TF32 off). Each
    error is max |got - ref| / max(1, max |ref|), ref the float64 result:
    the block at (1, 257, E) over E / 64 heads for E in `F32_ERROR_E`; the
    dropout forward's out and lse, and the backward's dq, dk, dv, at (1, n,
    4, 64) for n in `F32_ERROR_N`, and at (1, 257, 4, 256). A shape the
    tree's kernels refuse is recorded as refused. Also the device ms of the block at (16, 257,
    1024), and of the forward and the backward at (32, 257, 16, 64)."""
    from maskbit_tpu_torch.nn import attention_block as ab
    from maskbit_tpu_torch.nn import dropout_attention as da

    f32, f64 = torch.float32, torch.float64

    def rel(got, ref):
        return (got.to(f64) - ref).abs().max().item() / max(1.0, ref.abs().max().item())

    out = {"block": [], "forward": [], "backward": []}
    for e in F32_ERROR_E:
        inp = _block_inputs(torch, 1, 257, e, seed=e, vectors=f32, dtype=f32)
        heads = e // 64
        ref = _block_f64(torch, inp, heads)
        row = {"e": e, "plain_err": rel(ab.fused_attention_block_reference(**inp, num_heads=heads),
                                        ref)}
        try:
            row["kernel_err"] = rel(ab.fused_attention_block(**inp, num_heads=heads), ref)
        except ValueError as err:
            row["refused"] = str(err)
        log(f"[f32_error] block E={e}: {row}")
        out["block"].append(row)
        del inp, ref
    gf = torch.Generator(device="cuda").manual_seed(1)  # g below draws the backward's, as before
    for n in F32_ERROR_N:
        q, k, v = (torch.randn(1, n, 4, 64, generator=gf, device="cuda") for _ in range(3))
        seeds = torch.randint(0, 2**31, (1, 4), generator=gf, device="cuda")
        wide = [t.to(f64) for t in (q, k, v)]
        ref, lse_ref = da.dropout_attention_reference(*wide, seeds, RATE), _lse(torch, *wide[:2])
        got, lse = da.launch_forward(q, k, v, da.seeds_as_int32(seeds, (1, 4)), RATE)
        row = {"n": n, "out_err": rel(got, ref),
               "out_plain_err": rel(da.dropout_attention_reference(q, k, v, seeds, RATE), ref),
               "lse_err": rel(lse, lse_ref), "lse_plain_err": rel(_lse(torch, q, k), lse_ref)}
        row["within_3x_plain"] = (row["out_err"] <= 3 * row["out_plain_err"]
                                  and row["lse_err"] <= 3 * row["lse_plain_err"])
        log(f"[f32_error] forward n={n}: {row}")
        out["forward"].append(row)
        del ref, lse_ref, wide
    g = torch.Generator(device="cuda").manual_seed(0)
    for n in F32_ERROR_N:
        q, k, v, w = (torch.randn(1, n, 4, 64, generator=g, device="cuda") for _ in range(4))
        seeds = torch.randint(0, 2**31, (1, 4), generator=g, device="cuda")
        refs = da.dropout_attention_backward_reference(*(t.to(f64) for t in (q, k, v, w)),
                                                       seeds, RATE)
        plain = da.dropout_attention_backward_reference(q, k, v, w, seeds, RATE)
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        da.dropout_attention(qg, kg, vg, seeds, RATE).backward(w)
        row = {"n": n}
        for name, got, p, ref in zip(("dq", "dk", "dv"), (qg.grad, kg.grad, vg.grad), plain, refs):
            row[f"{name}_err"], row[f"{name}_plain_err"] = rel(got, ref), rel(p, ref)
        log(f"[f32_error] backward n={n}: {row}")
        out["backward"].append(row)
        del refs, plain
    # past head dim 128 (each 64-wide chunk of d, each key tile of the
    # forward and each 16-row step of the backward has fresh accumulators):
    # the forward and the backward at (1, 257, 4, 256)
    gw = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, w = (torch.randn(1, 257, 4, F32_ERROR_WIDE_D, generator=gw, device="cuda")
                  for _ in range(4))
    seeds = torch.randint(0, 2**31, (1, 4), generator=gw, device="cuda")
    wide = [t.to(f64) for t in (q, k, v, w)]
    ref, lse_ref = da.dropout_attention_reference(*wide[:3], seeds, RATE), _lse(torch, *wide[:2])
    refs = da.dropout_attention_backward_reference(*wide, seeds, RATE)
    plain = da.dropout_attention_backward_reference(q, k, v, w, seeds, RATE)
    row = {"d": F32_ERROR_WIDE_D, "n": 257,
           "out_plain_err": rel(da.dropout_attention_reference(q, k, v, seeds, RATE), ref),
           "lse_plain_err": rel(_lse(torch, q, k), lse_ref),
           **{f"{name}_plain_err": rel(p, r) for name, p, r in zip(("dq", "dk", "dv"), plain,
                                                                    refs)}}
    try:
        got, lse = da.launch_forward(q, k, v, da.seeds_as_int32(seeds, (1, 4)), RATE)
        row.update(out_err=rel(got, ref), lse_err=rel(lse, lse_ref))
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        da.dropout_attention(qg, kg, vg, seeds, RATE).backward(w)
        for name, got, r in zip(("dq", "dk", "dv"), (qg.grad, kg.grad, vg.grad), refs):
            row[f"{name}_err"] = rel(got, r)
    except ValueError as err:  # a tree from before the kernels past 128
        row["refused"] = str(err)
    log(f"[f32_error] head dim {F32_ERROR_WIDE_D}, forward and backward: {row}")
    out["wide"] = row
    del refs, plain, wide
    inp = _block_inputs(torch, 2 * SERVE_BATCH, 257, 1024, seed=1, vectors=f32, dtype=f32)
    out["block_ms"] = sum(_device_breakdown(
        torch, lambda: ab.fused_attention_block(**inp, num_heads=HEADS)).values())
    q, k, v, w = (torch.randn(TRAIN_BATCH, 257, HEADS, 64, generator=g, device="cuda")
                  for _ in range(4))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    seeds = torch.randint(0, 2**31, (TRAIN_BATCH, HEADS), generator=g, device="cuda")
    o = da.dropout_attention(q, k, v, seeds, RATE)
    times = _device_breakdown(torch, lambda: torch.autograd.grad(o, (q, k, v), w,
                                                                 retain_graph=True))
    out["backward_ms"] = sum(times.values())
    seeds32 = da.seeds_as_int32(seeds, (TRAIN_BATCH, HEADS))
    qd, kd, vd = (t.detach() for t in (q, k, v))
    out["forward_ms"] = sum(_device_breakdown(
        torch, lambda: da.launch_forward(qd, kd, vd, seeds32, RATE)).values())
    log(f"[f32_error] device ms: block (16, 257, 1024) {out['block_ms']:.4f}, forward "
        f"(32, 257, 16, 64) {out['forward_ms']:.4f}, backward {out['backward_ms']:.4f} ({times})")
    return out


PHASES = ("kernels", "dropout", "generator", "slice", "train_check", "train", "train_data",
          "eval", "tokenizer_train", "variants", "distributed", "sharded", "split",
          "split_scale", "multicard", "system_check", "float32", "wide_heads")


def _args(argv):
    import argparse

    p = argparse.ArgumentParser(description="Smoke run of maskbit_tpu_torch on one CUDA card.")
    p.add_argument("--phases", default=",".join(PHASES),
                   help="comma-separated subset of %(default)s (device and build always run), "
                        "or f32_error (not in the default run); the JSON lines are printed only "
                        "when all of the default run")
    p.add_argument("--tree", default=ROOT,
                   help="checkout whose maskbit_tpu_torch to drive (default: this one), e.g. "
                        "a parent commit unpacked beside it, to compare two trees with one "
                        "script")
    p.add_argument("--all-widths", action="store_true",
                   help="phase 3 times the kernels at every head dim it checks, not only at "
                        f"{TIMED_HEAD_DIMS}")
    args = p.parse_args(argv)
    args.phases = [x for x in args.phases.split(",") if x]
    unknown = set(args.phases) - set(PHASES) - {"f32_error"}
    if unknown:
        p.error(f"unknown phases {sorted(unknown)}")
    return args


def _wide_records(widths: dict, f32: dict, wide: dict, time_keys: tuple) -> list:
    """The final record's rows of the kernels past head dim 128 (bf16:
    csrc/attention_wide_bf16.cuh, float32: csrc/attention_wide_f32.cuh), from
    phases 3 (`widths`), 17 (`f32`) and 18 (`wide`):
    launched by phase 18 (the flagship at heads=4, d = 256: its sampler call
    the block and its core, its Stage-II steps the dropout pair), timed at d
    = 256 (and 192: "widths") in phases 3 and 17, held against the plain
    versions there at 192 and 256 and at `WIDE_SHAPES` (144, 200, 256,
    320, 1024)."""
    pa = "maskbit_tpu/nn/pallas_attention.py"
    replaces = {"fused_attention_block": (f"{pa}:532", "attention_block"),
                "dropout_attention_fwd": (f"{pa}:232", "dropout_attention_fwd"),
                "dropout_attention_bwd": (f"{pa}:274", "dropout_attention_bwd"),
                "fused_attention": (f"{pa}:94", "fused_attention")}
    wide_src = {"bfloat16": "maskbit_tpu_torch/csrc/attention_wide_bf16.cuh",
                "float32": "maskbit_tpu_torch/csrc/attention_wide_f32.cuh"}
    head_dims = {"bfloat16": "past 128 (instantiated at 192 and 256, streamed in 256-wide "
                             "output panels past 256; others padded)",
                 "float32": "past 128 (instantiated at 192 and 256, streamed in 256-wide "
                            "output panels past 256, dK and dV in 128-wide ones; others "
                            "padded)"}
    wide_errs = {"fused_attention_block": ("block",), "dropout_attention_fwd": ("fwd",),
                 "dropout_attention_bwd": ("dq", "dk", "dv"), "fused_attention": ("fused",)}
    phase3_errs = {"fused_attention_block": lambda r: r["block_err"],
                   "dropout_attention_fwd": lambda r: r["fwd_err"],
                   "dropout_attention_bwd": lambda r: max(r["bwd_errs"]),
                   "fused_attention": lambda r: r["fused_err"]}
    shape_key = {"fused_attention_block": "block_shape", "fused_attention": "fused_shape"}
    bf16_past = [r for r in widths["rows"] if r["d"] > 128]  # n = 257 (timed) and 17
    rows = []
    for dt, tag in (("bfloat16", "bf16"), ("float32", "float")):
        f32_dt = dt == "float32"
        for name, (source_line, key) in replaces.items():
            if f32_dt:
                timed = f32["kernels"]["timed"]
                checked = [max(r["errs"][x] for x in wide_errs[name])
                           for r in f32["kernels"]["rows"] if r["d"] > 128]
                shape = timed[256][name]["shape"]
            else:
                timed = {r["d"]: r for r in bf16_past if name in r}
                checked = [phase3_errs[name](r) for r in bf16_past]
                shape = timed[256][shape_key.get(name, "dropout_shape")]
            checked += [max(r["errs"][x] for x in wide_errs[name])
                        for r in (f32["kernels"]["wide"] if f32_dt else widths["wide"])]
            at = timed[256][name]
            path = wide[dt]["train" if name.startswith("dropout") else "serve"]
            rows.append({
                "name": f"{name}_wide_{'f32' if f32_dt else 'bf16'}", "route": "cuda",
                "source": wide_src[dt], "replaces": source_line, "dtype": dt,
                "head_dims": head_dims[dt],
                "cuda_kernels": WIDE_CUDA_KERNELS[name][tag],
                "launches": path["launches"].get(f"{key}@256/{dt}", 0),
                "launches_head_dim": 256, "max_abs_err": max(checked), "shape": shape,
                **{k: at[k] for k in time_keys}, "library_ms": at.get("library_ms"),
                **({"library_chain_ms": at["library_chain_ms"]} if "library_chain_ms" in at
                   else {}),
                "widths": [{"d": d, **{k: timed[d][name][k] for k in time_keys}}
                           for d in WIDE_TIMED_HEAD_DIMS],
                "ptxas": [k for k in widths["ptxas"] if k["kernel"].replace(
                    "__nv_bfloat16", "bf16") in WIDE_CUDA_KERNELS[name][tag]]})
    return rows


def _check_wgmma_kernels(bf16_rows: list, f32_rows: list) -> None:
    """Raises unless every width ran the wgmma kernels and none of the
    mma.sync kernels they replaced: in bf16 at every width (phase 3's rows)
    and in float32 past 128 (phase 17's), whose attention kernels must
    also be exactly the 3xTF32 ones of `WIDE_CUDA_KERNELS`. Each row's
    `kernels`: the CUDA kernels one call of each function launched."""
    bf16 = [r["kernels"] for r in bf16_rows if "kernels" in r]
    f32 = [r["kernels"] for r in f32_rows if "kernels" in r]
    mma = sorted({k for by_name in bf16 + f32 for ks in by_name.values() for k in ks
                  if "_mma" in k or k.startswith(WIDE_MMA_SYNC_KERNELS)})
    if mma:
        raise AssertionError(f"mma.sync kernels ran: {mma}")
    stray = sorted({k for by_name in f32 for name, ks in by_name.items() for k in ks
                    if "attn" in k and k not in WIDE_CUDA_KERNELS[name]["float"]})
    if not f32 or stray:
        raise AssertionError(f"float32 past head dim 128: kernels {f32}, not the 3xTF32 ones "
                             f"{stray}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:  # a rank of phase 11
        return _rank_main(json.loads(argv[1]))
    import torch

    t_start = time.perf_counter()
    args = _args(argv)
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
    seconds = {}

    def phase(name, fn, *a, **kw):
        """fn(*a, **kw) if the phase runs (else None), its seconds logged."""
        if name not in run:
            return None
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        seconds[name] = time.perf_counter() - t0
        log(f"[time] phase {name}: {seconds[name]:.1f} s")
        return out

    kern = phase("kernels", phase_kernels, torch)
    timed_dims = tuple(HEAD_DIM_SHAPES) if args.all_widths else TIMED_HEAD_DIMS
    drop, widths = phase("dropout", lambda: (phase_dropout_kernels(torch),
                                             phase_head_dims(torch, timed_dims))) or (None, None)
    # phase 17 right after the other kernels: late in a long process CUPTI
    # loses most of a profile's events
    f32 = phase("float32", phase_float32, torch, device_info)
    wide = phase("wide_heads", phase_wide_heads, torch, device_info)
    f32_error = phase("f32_error", phase_f32_error, torch)
    phase("generator", phase_generator, torch)
    sl = phase("slice", phase_slice, torch, device_info)
    check = phase("train_check", phase_train_check, torch)
    tr = phase("train", phase_train_slice, torch, device_info)
    data = phase("train_data", phase_train_data, torch, device_info, tr)
    ev = phase("eval", phase_eval, torch, device_info)
    tok = phase("tokenizer_train", phase_tokenizer_train, torch, device_info)
    var = phase("variants", phase_variants, torch, device_info)
    dp = phase("distributed", phase_distributed, torch, device_info)
    sh = phase("sharded", phase_sharded, torch, device_info, data_parallel=dp and dp["ranks"])
    sp = phase("split", phase_split, torch, device_info,
               stage2_step_s=tr and tr["median_step_s"])
    sc = phase("split_scale", phase_split_scale, torch, device_info)
    mc = phase("multicard", phase_multicard, torch, device_info)
    syscheck = phase("system_check", phase_system_check, torch)
    os.makedirs(OUT_DIR, exist_ok=True)
    results = {"device": device_info, "phase_seconds": seconds,
               "kernel_rows": kern and kern["rows"], "dropout_rows": drop,
               "head_dim_rows": widths, "slice": sl, "train_check": check, "train": tr,
               "train_data": data, "eval": ev, "tokenizer_train": tok, "variants": var,
               "distributed": dp, "sharded": sh, "split": sp, "split_scale": sc,
               "multicard": mc, "system_check": syscheck, "float32": f32,
               "wide_heads": wide, "f32_error": f32_error}
    if run != set(PHASES):
        with open(os.path.join(OUT_DIR, f"result_{os.path.basename(tree)}.json"), "w") as f:
            json.dump(results, f, indent=1)
        log(f"[done] phases {args.phases} passed in {time.perf_counter() - t_start:.1f} s")
        return 0

    def row(name, source, replaces, launches, rows, **extra):
        first = rows[0]
        # phase 7 drives all four kernels again: its counts, read after its first run
        key = "attention_block" if name == "fused_attention_block" else name
        data_launches = data["launches"][key]
        # phase 10: the Bert generator served and trained
        bert = {"launches_bert_serve": var["serve"]["launches"][key],
                "launches_bert_train": var["train"]["launches"][key]}
        # phase 11: per rank, Stage II's stop run (dropout kernels) or the sharded eval
        if name.startswith("dropout"):
            per_rank = {"launches_distributed_per_rank": [
                r["launches"][name] for r in dp["stage2"]["ranks"]]}
        else:
            per_rank = {"launches_distributed_eval_per_rank": [
                r["eval_launches"][key] for r in dp["ranks"]]}
        # phase 12: per rank and mesh, the dropout kernels' launches in the
        # flagship's steps and their heads, or the block's in the sampler
        # with the whole EMA weights under tensor=2
        per_rank["launches_sharded_per_rank"] = [
            {"mesh": mesh, "coords": r["coords"],
             **({"launches": r["launches"][name], "heads": r["heads"]}
                if name.startswith("dropout") else
                {"launches": r["sample_launches"][key], "heads": r["block_heads"]})}
            for mesh, m in sh["meshes"].items() for r in m["ranks"]
            if name.startswith("dropout") or "sample_launches" in r]
        # phases 13 and 14: per worker process of the split sampler, the
        # block's chain (with its attention forward) on every layer of every
        # step; 14 only on a host with several cards (else null)
        if not name.startswith("dropout"):
            per_rank["launches_split_per_replica"] = [c[key] for c in sp["sampler"]["launches"]]
            per_rank["launches_split_scale_per_worker"] = sc and [
                {"batch": r["batch"], "cards": x["cards"],
                 "launches": [c[key] for c in x["launches_per_worker"]]}
                for r in sc["rows"] for x in r["splits"]]
        # phase 15 (four cards, else null): per rank, the dropout kernels in
        # Stage II's data=4 stop run and at fsdp=2 x tensor=2 (their heads),
        # or the block in the fsdp x tensor ranks' sampling and in eval_maskbit
        if mc is None:
            per_rank["launches_multicard_per_rank"] = None
        elif name.startswith("dropout"):
            per_rank["launches_multicard_per_rank"] = [
                {"run": "data=4", "launches": [r["launches"][name]
                                               for r in mc["stage2"]["ranks"]]},
                {"run": "fsdp=2 x tensor=2", "launches": [r["launches"][name]
                                                          for r in mc["sharded"]["ranks"]],
                 "heads": mc["sharded"]["ranks"][0]["heads"]}]
        else:
            per_rank["launches_multicard_per_rank"] = [
                {"run": "fsdp=2 x tensor=2 sampling",
                 "launches": [r["sample_launches"][key] for r in mc["sharded"]["ranks"]]},
                {"run": "eval_maskbit", "launches": [r["eval_launches"][key]
                                                     for r in mc["combined"]["ranks"]]}]
        # phase 16: run `flagship` of the system check (head dim 64)
        flagship = syscheck["runs"]["flagship"]
        stage = "launches_sample" if key in ("attention_block", "fused_attention") else (
            "launches_train")
        per_rank["launches_system_check"] = flagship[stage][key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "launches_train_data": data_launches, **bert, **per_rank,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": first["ms"], "call_ms": first["call_ms"], "plain_ms": first["plain_ms"],
                "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
                "library_ms": first.get("library_ms"), **extra}

    src = "maskbit_tpu_torch/csrc/dropout_attention.cu"
    pa = "maskbit_tpu/nn/pallas_attention.py"
    shape_row = {tuple(r["shape"][:2]): r for r in kern["rows"]}
    eval_row = shape_row[(2 * EVAL_BATCH, 257)]  # the block at the eval shape (200, 257, 1024)
    row_keys = ("shape", "ms", "library_chain_ms", "plain_ms", "bound_ms", "max_abs_err", "plan")
    record = {"kernels": [
        # no one PyTorch call computes the block: library_ms stays null, and
        # library_chain_ms is the chain of library calls
        row("fused_attention_block", "maskbit_tpu_torch/csrc/attention_block.cu", f"{pa}:532",
            sl["launches"], kern["rows"], library_chain_ms=kern["rows"][0]["library_chain_ms"],
            launches_eval=ev["launches"]["attention_block"],
            eval_shape={k: eval_row[k] for k in row_keys},
            # a replica's share of the serve and the eval batch in phase 13
            split_shapes=[{k: shape_row[(b, 257)][k] for k in row_keys}
                          for b in (SERVE_BATCH, EVAL_BATCH)]),
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
    # the other head dims' instantiations of the same kernel templates:
    # launched by phase 16's run `tool` (head dim 32, the sampler's block and
    # the Stage-II dropout pair), timed in phase 3 at head dim 32 (the run's
    # shapes) and at 16 and 128, or every width with --all-widths ("widths"),
    # with the CUDA kernels each width launched ("kernels_by_width")
    tool = syscheck["runs"]["tool"]
    tool_d = tool["head_dim"]
    narrow_rows = [r for r in widths["rows"] if r["d"] <= 128]  # the templates' widths
    width_rows = {r["d"]: r for r in narrow_rows if "dropout_attention_fwd" in r}
    generic = {"fused_attention_block": (f"{pa}:532", "maskbit_tpu_torch/csrc/attention_block.cu",
                                         tool["launches_sample"]["attention_block"]),
               "dropout_attention_fwd": (f"{pa}:232", "maskbit_tpu_torch/csrc/attention_fwd.cuh",
                                         tool["launches_train"]["by_head_dim"].get(
                                             f"dropout_attention_fwd@{tool_d}", 0)),
               "dropout_attention_bwd": (f"{pa}:274", src, tool["launches_train"]["by_head_dim"].get(
                   f"dropout_attention_bwd@{tool_d}", 0)),
               "fused_attention": (f"{pa}:94", "maskbit_tpu_torch/csrc/attention_fwd.cuh",
                                   tool["launches_sample"]["by_head_dim"].get(
                                       f"fused_attention@{tool_d}", 0))}
    time_keys = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by")
    _check_wgmma_kernels(widths["rows"], f32["kernels"]["rows"])
    kernels_by_width = {r["d"]: r["kernels"] for r in widths["rows"] if "kernels" in r}
    errs = {"fused_attention_block": lambda r: r["block_err"],
            "dropout_attention_fwd": lambda r: r["fwd_err"],
            "dropout_attention_bwd": lambda r: max(r["bwd_errs"]),
            "fused_attention": lambda r: r["fused_err"]}
    for name, (replaces, source, launches) in generic.items():
        at = width_rows[tool_d][name]
        record["kernels"].append({
            "name": f"{name}_other_widths", "route": "cuda", "source": source,
            "replaces": replaces, "head_dims": "multiples of 16 in [16, 128] but 64",
            "launches": launches,
            "launches_head_dim": tool_d,
            "max_abs_err": max(errs[name](r) for r in narrow_rows),
            # the shapes the wrappers zero-pad (head dims 8, 72, 125; the
            # block also at E = 80 and 4608)
            "padded_max_abs_err": max(
                [r["errs"][{"fused_attention_block": "block", "dropout_attention_fwd": "fwd",
                            "fused_attention": "fused"}[name]] if name in (
                    "fused_attention_block", "dropout_attention_fwd", "fused_attention")
                 else max(r["errs"][x] for x in ("dq", "dk", "dv"))
                 for r in widths["padded"] if "errs" in r]
                + [r["err"] for r in widths["padded"]
                   if "err" in r and name == "fused_attention_block"]),
            **{k: at[k] for k in time_keys}, "library_ms": at.get("library_ms"),
            **({"library_chain_ms": at["library_chain_ms"]} if "library_chain_ms" in at else {}),
            "widths": [{"d": d, "shape": r[{"fused_attention_block": "block_shape",
                                            "fused_attention": "fused_shape"}.get(
                                                name, "dropout_shape")],
                        **{k: r[name][k] for k in time_keys},
                        "library_ms": r[name].get("library_ms", r[name].get("library_chain_ms"))}
                       for d, r in sorted(width_rows.items())],
            # the CUDA kernels one call launched at each width, timed or not
            "kernels_by_width": {str(d): ks[name] for d, ks in sorted(kernels_by_width.items())}})
    # the float32 kernels (phase 17): launched by its train CLI (the dropout
    # pair; the block in its generations) and its server (the block and its
    # attention core), timed at the flagship's shapes (head dim 64) and at 32
    # and 128 ("widths")
    f32_src = "maskbit_tpu_torch/csrc/attention_f32.cu"
    f32_train, f32_serve = f32["train"]["launches"], f32["serve"]["launches"]
    f32_rows = {"fused_attention_block": (f"{pa}:532", "attention_block", "block"),
                "dropout_attention_fwd": (f"{pa}:232", "dropout_attention_fwd", "fwd"),
                "dropout_attention_bwd": (f"{pa}:274", "dropout_attention_bwd", None),
                "fused_attention": (f"{pa}:94", "fused_attention", "fused")}
    for name, (replaces, key, err_key) in f32_rows.items():
        at = f32["kernels"]["timed"][64][name]
        errs = [max(r["errs"][x] for x in ("dq", "dk", "dv")) if err_key is None
                else r["errs"][err_key] for r in f32["kernels"]["rows"] if r["d"] <= 128]
        serve_path = not name.startswith("dropout")
        # the padded shapes' errors (head dims 8, 72, 125; the block also at
        # E = 80 and 4608)
        padded_errs = [max(r["errs"][x] for x in ("dq", "dk", "dv")) if err_key is None
                       else r["errs"][err_key] for r in f32["kernels"]["padded"] if "errs" in r]
        if name == "fused_attention_block":
            padded_errs += [r["err"] for r in f32["kernels"]["padded"] if "err" in r]
        f32_keys = time_keys + ("bound_ffma_ms", "bound_ffma_by")
        # the 3xTF32 kernels' ptxas report (registers, spill bytes)
        tf32 = {"dropout_attention_fwd": ("attn_fwd_tf32",),
                "dropout_attention_bwd": ("attn_bwd_tf32",),
                "fused_attention": ("attn_fwd_tf32",),
                "fused_attention_block": ("proj_tf32", "split_tf32", "attn_fwd_tf32")}
        record["kernels"].append({
            "name": f"{name}_f32", "route": "cuda", "source": f32_src, "replaces": replaces,
            "dtype": "float32", "head_dims": "[1, 128] (multiples of 16 native, others padded)",
            "cuda_kernels": F32_CUDA_KERNELS[name],
            "launches": (f32_serve if serve_path else f32_train).get(f"{key}@64/float32", 0),
            "launches_train_cli": f32_train.get(f"{key}@64/float32", 0),
            "max_abs_err": max(errs), "padded_max_abs_err": max(padded_errs),
            "shape": at["shape"],
            **{k: at[k] for k in f32_keys}, "library_ms": at.get("library_ms"),
            **({"library_chain_ms": at["library_chain_ms"], "chain": at["chain"]}
               if "library_chain_ms" in at else {}),
            **({"ptxas": [k for k in f32["kernels"]["ptxas"]
                          if any(x in k["kernel"] for x in tf32[name])]}
               if name in tf32 else {}),
            "widths": [{"d": d, "shape": t[name]["shape"], **{k: t[name][k] for k in f32_keys},
                        "library_ms": t[name].get("library_ms", t[name].get("library_chain_ms"))}
                       for d, t in sorted(f32["kernels"]["timed"].items()) if d <= 128]})
    # past head dim 128: their own rows
    record["kernels"] += _wide_records(widths, f32, wide, time_keys)
    bert_path = {"fused_attention_block": "launches_bert_serve",
                 "fused_attention": "launches_bert_serve",
                 "dropout_attention_fwd": "launches_bert_train",
                 "dropout_attention_bwd": "launches_bert_train"}
    idle = [k["name"] for k in record["kernels"] if k["launches"] <= 0
            or k.get("launches_train_cli", 1) <= 0]
    idle += [k["name"] for k in record["kernels"] if "widths" not in k and (
            k["launches_train_data"] <= 0 or k["launches_system_check"] <= 0
            or k.get("launches_eval", 1) <= 0 or k[bert_path[k["name"]]] <= 0
            or min(k.get("launches_distributed_per_rank", [1])) <= 0
            or min(k.get("launches_distributed_eval_per_rank", [1])) <= 0
            or min(x["launches"] for x in k["launches_sharded_per_rank"]) <= 0
            or min(k.get("launches_split_per_replica", [1])) <= 0
            or min([n for x in k.get("launches_split_scale_per_worker") or []
                    for n in x["launches"]] or [1]) <= 0
            or min([n for x in k["launches_multicard_per_rank"] or [] for n in x["launches"]]
                   or [1]) <= 0)]
    if idle:
        raise AssertionError(f"kernels of the main paths never launched there: {idle}")
    with open(os.path.join(OUT_DIR, "result.json"), "w") as f:
        json.dump(results, f, indent=1)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
