"""Full-system training check: train Stage I and Stage II from scratch on
synthetic class-structured images, sample, and verify class conditioning.

Counterpart of `tools/system_check.py`, with the port's own trainers
(`train/tokenizer_trainer.py`, `train/generator_trainer.py`), optimizer
(`train/optim.py`), EMA (`core/ema.py`) and sampler (`sampling/sample.py`):

    python -m maskbit_tpu_torch.cli.system_check                              # on the card
    python -m maskbit_tpu_torch.cli.system_check --device cpu --rehearsal     # a rehearsal

Synthetic task (the tool's): 10 classes; each 32 px image is a 2x2 grid of
quadrants whose colours come from the class (`CLASS_COLORS`, drawn from
`default_rng(1234)`), plus noise. Stage I trains the LFQ tokenizer (hidden
64, channel_mult (1, 2), 8-bit LFQ) against the PatchGAN-v2 discriminator
(hinge loss, LeCam, entropy annealing, the adaptive weight and the
discriminator's gate at step 150) for 400 steps at batch 32; its EMA weights
are the frozen tokenizer of Stage II. Each run then trains an LFQBert under
MLM (class-label dropout 0.1, EMA 0.995) on the 16x16 token grid (sequence
257 with the class token) and samples 30 images (labels 0..9, three each;
12 CFG steps, guidance 2.0 cosine, arccos, randomize_temperature 2.0):
  * `tool`: the tool's generator, hidden 128, depth 4, 4 heads (head dim 32,
    the kernels' d = 32 instantiations), mlp 256, 600 steps at lr 4e-4, AdamW as the
    tool's `make_optimizer(4e-4)`;
  * `flagship`: the 14-bit flagship's generator width and depth (hidden 1024,
    depth 24, 16 heads: head dim 64, the d = 64 instantiations; mlp 4096) with its
    AdamW (beta2 0.96, weight decay 0.045, grad-norm clip 1.0), 600 steps at
    lr 2e-4 after a linear warmup of 100 steps (the tool's 4e-4 without
    warmup is a 4-layer model's setting; the flagship warms up too).
Both set `attention_impl: fused` and `fused_attention_dropout: true`, as
every flagship config does: Stage II runs the dropout-attention forward and
backward kernels, the sampler the attention block. Seeds are the tool's:
data 0 (one stream: Stage I's 400 batches, then each run's Stage II takes
the same next 600), models 0 (Stage I) and 1 (the generator), Stage-II step
i draws from 1000 + i, the sampler from 7, the chance permutation from 9.

It passes when the reconstruction loss ends below 0.2x its first value and,
in each run, the samples' quadrant-colour MSE against their own classes is
below 0.35x the MSE against a permutation of the classes (the tool's two
thresholds); a failed threshold raises and the command exits non-zero.
`--rehearsal` runs the same end to end at `REHEARSAL`'s sizes (3 Stage-I and
3 Stage-II steps at batch 2, 2 sampling steps, the flagship run at depth 1)
and computes the thresholds without asserting them.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional

import numpy as np
import torch

from maskbit_tpu_torch.cli.common import build_module
from maskbit_tpu_torch.core.ema import swapped_in
from maskbit_tpu_torch.losses.mlm import MLMLossConfig
from maskbit_tpu_torch.losses.vqgan import VQGANLossConfig
from maskbit_tpu_torch.models.generator import LFQBert, init_generator_weights_
from maskbit_tpu_torch.models.tokenizer import ConvVQModel, init_tokenizer_weights_
from maskbit_tpu_torch.nn import attention_block
from maskbit_tpu_torch.nn.discriminator import NLayerDiscriminatorv2, init_discriminator_weights_
from maskbit_tpu_torch.sampling.sample import SamplingConfig, make_sampler
from maskbit_tpu_torch.train.generator_trainer import (
    init_generator_train_state,
    make_generator_train_step,
)
from maskbit_tpu_torch.train.optim import make_optimizer
from maskbit_tpu_torch.train.tokenizer_trainer import (
    init_tokenizer_train_state,
    make_tokenizer_train_step,
)
from maskbit_tpu_torch.utils.lr_schedules import get_schedule

RES = 32
NCLASS = 10
BATCH = 32
CODEBOOK = 256
TOK_STEPS, GEN_STEPS, SAMPLE_STEPS = 400, 600, 12
RECON_RATIO, MATCH_RATIO = 0.2, 0.35  # the tool's thresholds
SIZES = dict(tok_steps=TOK_STEPS, gen_steps=GEN_STEPS, sample_steps=SAMPLE_STEPS, batch=BATCH,
             flagship_depth=None)
# a rehearsal's sizes: it checks that the whole recipe runs, not that it learns
REHEARSAL = dict(tok_steps=3, gen_steps=3, sample_steps=2, batch=2, flagship_depth=1)

_template_rng = np.random.default_rng(1234)
CLASS_COLORS = _template_rng.uniform(0.1, 0.9, size=(NCLASS, 2, 2, 3)).astype(np.float32)

# the two Stage-II runs: generator widths and AdamW
RUNS = {
    "tool": dict(hidden_dim=128, depth=4, heads=4, mlp_dim=256, lr=4e-4, warmup=0,
                 beta2=0.999, weight_decay=1e-4),
    "flagship": dict(hidden_dim=1024, depth=24, heads=16, mlp_dim=4096, lr=2e-4, warmup=100,
                     beta2=0.96, weight_decay=0.045),
}


def make_batch(rng, batch=BATCH):
    labels = rng.integers(0, NCLASS, size=(batch,))
    quad = CLASS_COLORS[labels]  # (b, 2, 2, 3)
    imgs = np.repeat(np.repeat(quad, RES // 2, axis=1), RES // 2, axis=2)
    imgs = np.clip(imgs + rng.normal(scale=0.03, size=imgs.shape), 0, 1)
    return imgs.astype(np.float32), labels.astype(np.int32)


def quadrant_means(imgs):
    h = RES // 2
    return np.stack([
        imgs[:, :h, :h].mean((1, 2)), imgs[:, :h, h:].mean((1, 2)),
        imgs[:, h:, :h].mean((1, 2)), imgs[:, h:, h:].mean((1, 2)),
    ], axis=1).reshape(len(imgs), 2, 2, 3)


# Stage I's models, as the tool builds them (the JAX classes take the same keywords)
TOKENIZER = dict(num_channels=3, hidden_channels=64, channel_mult=(1, 2), num_resolutions=2,
                 num_res_blocks=1, token_size=8, codebook_size=CODEBOOK,
                 quantizer_type="lookup-free", entropy_loss_weight=0.02)
DISCRIMINATOR = dict(num_channels=3, hidden_channels=64, num_stages=1)
TOOL_LOSS = VQGANLossConfig(
    reconstruction_loss="l2", reconstruction_weight=4.0, quantizer_weight=1.0,
    perceptual_loss="none", perceptual_weight=0.0,
    discriminator_loss="hinge", discriminator_factor=1.0,
    discriminator_weight=0.02, discriminator_start=150,
    discriminator_gradient_penalty="adopt_weight",
    lecam_regularization_weight=0.001, entropy_annealing_steps=100,
    entropy_annealing_factor=2.0,
)


def generator_for(run: Dict, dtype=torch.bfloat16) -> LFQBert:
    return LFQBert(img_size=RES, hidden_dim=run["hidden_dim"], codebook_size=CODEBOOK,
                   codebook_splits=2, depth=run["depth"], heads=run["heads"],
                   mlp_dim=run["mlp_dim"], dropout=0.1, nclass=NCLASS, input_stride=2,
                   attention_impl="fused", fused_attention_dropout=True, dtype=dtype)


def _seconds(device: torch.device, t0: float) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def train_tokenizer(device: torch.device, rng, steps: int = TOK_STEPS, batch: int = BATCH,
                    log=print):
    """Stage I: (the tokenizer holding its EMA weights, frozen; metrics)."""
    model = build_module(lambda: ConvVQModel(**TOKENIZER, dtype=torch.bfloat16), device)
    disc = build_module(lambda: NLayerDiscriminatorv2(**DISCRIMINATOR, dtype=torch.bfloat16),
                        device)
    init_gen = torch.Generator(device=device).manual_seed(0)
    init_tokenizer_weights_(model, init_gen)
    init_discriminator_weights_(disc, init_gen)
    gen_opt = make_optimizer(model.parameters(), get_schedule("constant", 2e-4))
    disc_opt = make_optimizer(disc.parameters(), get_schedule("constant", 2e-4))
    state = init_tokenizer_train_state(model, disc, gen_opt, disc_opt)
    step = make_tokenizer_train_step(model, disc, TOOL_LOSS)

    log("=== Stage I: tokenizer + GAN ===")
    t0 = time.perf_counter()
    recon0 = None
    for i in range(steps):
        images, _ = make_batch(rng, batch)
        state, metrics = step(state, torch.from_numpy(images).to(device))
        if i % 100 == 0 or i == steps - 1:
            recon = float(metrics["reconstruction_loss"])
            recon0 = recon0 or recon
            log(f"  step {i}: recon={recon:.4f} d_weight={float(metrics['d_weight']):.4f} "
                f"disc={float(metrics['discriminator_loss']):.4f}")
    recon_final = float(metrics["reconstruction_loss"])
    seconds = _seconds(device, t0)
    log(f"  Stage I in {seconds:.1f}s; recon {recon0:.4f} -> {recon_final:.4f}")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state.ema.params[name])
    return model.requires_grad_(False).eval(), {
        "recon_first": recon0, "recon_last": recon_final, "stage1_seconds": seconds,
        "disc_updates": state.disc_opt.count}


def train_generator(run: Dict, tokenizer: ConvVQModel, device: torch.device, rng,
                    steps: int = GEN_STEPS, batch: int = BATCH, log=print):
    """Stage II: (the generator, its train state, metrics)."""
    gen = build_module(lambda: generator_for(run), device)
    init_generator_weights_(gen, torch.Generator(device=device).manual_seed(1))
    schedule = get_schedule("constant_with_warmup" if run["warmup"] else "constant", run["lr"],
                            num_warmup_steps=run["warmup"] or None)
    opt = make_optimizer(gen.parameters(), schedule, beta2=run["beta2"],
                         weight_decay=run["weight_decay"], max_grad_norm=1.0)
    state = init_generator_train_state(gen, opt)
    step = make_generator_train_step(gen, tokenizer, MLMLossConfig(), "arccos", 0.1,
                                     {"decay": 0.995})

    log("=== Stage II: masked generator ===")
    draws = torch.Generator(device=device)
    t0 = time.perf_counter()
    for i in range(steps):
        images, labels = make_batch(rng, batch)
        state, metrics = step(state, torch.from_numpy(images).to(device),
                              torch.from_numpy(labels).to(device),
                              generator=draws.manual_seed(1000 + i))
        if i % 150 == 0 or i == steps - 1:
            mlm, acc = float(metrics["mlm_loss"]), float(metrics["masked_correct_tokens"])
            log(f"  step {i}: mlm={mlm:.4f} masked_acc={acc:.4f}")
    seconds = _seconds(device, t0)
    log(f"  Stage II in {seconds:.1f}s")
    return gen, state, {"mlm_loss": mlm, "masked_acc": acc, "stage2_seconds": seconds}


def sample_and_score(gen: LFQBert, state, tokenizer: ConvVQModel, device: torch.device,
                     num_steps: int = SAMPLE_STEPS, log=print) -> Dict:
    """30 CFG samples with the EMA weights; their quadrant-colour MSE
    against their labels' colours and against a permutation of them."""
    log("=== Sampling ===")
    cfg = SamplingConfig(num_steps=num_steps, guidance_scale=2.0, guidance_annealing="cosine",
                         scale_pow=2.5, randomize_temperature=2.0,
                         mask_schedule_strategy="arccos", mask_token=gen.mask_token,
                         patch_size=RES // 2, codebook_size=CODEBOOK, codebook_splits=2)
    labels = np.arange(NCLASS, dtype=np.int32).repeat(3)
    t0 = time.perf_counter()
    with swapped_in(state.ema, gen.eval()):
        images, _ = make_sampler(gen, tokenizer, cfg)(
            torch.from_numpy(labels).to(device),
            generator=torch.Generator(device=device).manual_seed(7))
    seconds = _seconds(device, t0)
    images = np.clip(images.float().cpu().numpy(), 0, 1)

    got = quadrant_means(images)
    target = CLASS_COLORS[labels]
    err_match = float(np.mean((got - target) ** 2))
    # chance baseline: compare against every sample matched to a random class
    perm = np.random.default_rng(9).permutation(len(labels))
    err_chance = float(np.mean((got - target[perm]) ** 2))
    log(f"  quadrant-color MSE: matched={err_match:.5f} chance={err_chance:.5f}")
    return {"matched": err_match, "chance": err_chance, "sample_seconds": seconds,
            "finite": bool(np.isfinite(images).all()), "shape": list(images.shape)}


def run_check(device: str = "cuda", rehearsal: bool = False, log=print,
              flagship_depth: Optional[int] = None) -> Dict:
    """Stage I, then Stage II and sampling for each of `RUNS`. Returns
    {"tokenizer": ..., "runs": {name: ...}, "passed": bool}; a failed
    threshold raises AssertionError (after every run has run), except in a
    `rehearsal`, which runs at `REHEARSAL`'s sizes. `flagship_depth`: the
    run `flagship` at that depth (its width unchanged) instead of 24, or
    of the rehearsal's 1."""
    sizes = dict(REHEARSAL if rehearsal else SIZES)
    if flagship_depth is not None:
        sizes["flagship_depth"] = flagship_depth
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for a rehearsal on the CPU")
    rng = np.random.default_rng(0)
    batch = sizes["batch"]
    tokenizer, tok = train_tokenizer(device, rng, sizes["tok_steps"], batch, log)
    tok["passed"] = tok["recon_last"] < tok["recon_first"] * RECON_RATIO
    stage2_data = rng.bit_generator.state  # each run's Stage II sees the same batches
    results = {"tokenizer": tok, "runs": {}}
    for name, run in RUNS.items():
        run = dict(run)
        if name == "flagship" and sizes["flagship_depth"] is not None:
            run["depth"] = sizes["flagship_depth"]
        log(f"--- run {name}: hidden {run['hidden_dim']}, depth {run['depth']}, "
            f"{run['heads']} heads (head dim {run['hidden_dim'] // run['heads']})")
        rng = np.random.default_rng(0)
        rng.bit_generator.state = stage2_data
        attention_block.reset_launch_counts()
        gen, state, trained = train_generator(run, tokenizer, device, rng, sizes["gen_steps"],
                                              batch, log)
        train_launches = attention_block.launch_counts()
        attention_block.reset_launch_counts()
        scored = sample_and_score(gen, state, tokenizer, device, sizes["sample_steps"], log)
        results["runs"][name] = {
            **trained, **scored, "head_dim": run["hidden_dim"] // run["heads"],
            "depth": run["depth"],
            "passed": scored["finite"] and scored["matched"] < scored["chance"] * MATCH_RATIO,
            "launches_train": train_launches,
            "launches_sample": attention_block.launch_counts()}
        del gen, state
    results["passed"] = tok["passed"] and all(r["passed"] for r in results["runs"].values())
    failed = ([] if tok["passed"] else ["tokenizer failed to converge"]) + [
        f"run {name}: generated samples are not class-conditioned"
        for name, r in results["runs"].items() if not r["passed"]]
    if failed and not rehearsal:
        raise AssertionError("; ".join(failed) + f": {json.dumps(results)}")
    if not failed:
        log("SYSTEM CHECK PASSED: two-stage training + CFG sampling are functional")
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--rehearsal", action="store_true",
                        help="a few steps of each stage, the thresholds computed, not asserted")
    args = parser.parse_args(argv)
    results = run_check(args.device, args.rehearsal)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
