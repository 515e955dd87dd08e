"""Port parity: `maskbit_tpu_torch.cli.system_check` against the JAX package's
`tools/system_check.py`, which is loaded from its path, unchanged.

* The synthetic data: `CLASS_COLORS`, `make_batch` and `quadrant_means` equal
  the tool's bit for bit, for the same seeds.
* Three Stage-I steps at the tool's widths, losses and optimizer (hidden
  64, channel_mult (1, 2), 8-bit LFQ, the v2 discriminator, hinge + LeCam +
  entropy annealing, the adaptive weight; AdamW at 2e-4, epsilon 1e-8),
  from the same weights (the JAX ones, carried across with
  `compat.weights`), on the tool's first batches cut to 4 images. Three
  changes from the tool, on both sides alike: float32 instead of bf16 (the
  frameworks round bf16 at other places); the discriminator's gate at step
  1 instead of 150, so that the steps run gated, then through the gate with
  the adaptive weight live; and the entropy temperature 0.1 instead of
  0.01, where the trajectory is chaotic in the JAX package itself (see
  `tests/test_torch_tokenizer_train.py`; at 0.01 the per-sample entropy
  drifts 5e-3 apart by the third step, at 0.1 every metric stays within
  3e-5). Every logged metric within rtol 1e-4 and atol 1e-6, the
  tolerances of `tests/test_torch_tokenizer_train.py`.
* Three Stage-II steps at the tool's generator widths (hidden 128, 4 heads,
  so head dim 32; mlp 256; 32 px at stride 2, sequence 257; depth cut from
  4 to 2 to keep the file short) with
  `fused_attention_dropout` on both sides: JAX's Pallas kernel in
  interpret mode, the port's plain version with the same hash mask. The
  port is given the JAX step's draws: the masking and label-drop uniforms,
  computed from the step's key as in `tests/test_torch_train_step.py`, and
  the (b, h) seeds of each layer's kernel call, recorded from the JAX step
  with `jax.debug.callback` (the JAX package unchanged); hidden dropout is
  0 (its masks are drawn by each framework's own generator), attention
  dropout 0.1, batch 4. Float32: the loss within rtol 1e-5, the grad norm
  within rtol 1e-4, the parameters and EMA shadows within atol 2e-6 (the
  tolerances of `tests/test_torch_train_step.py`, for the same reasons).
* A rehearsal of the whole check on the CPU: Stage I and both runs at 3 + 3
  steps, batch 2, the flagship run cut to depth 1, 2 sampling steps, end to
  end, computing the thresholds without asserting convergence.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from maskbit_tpu.compat.torch_export import export_generator_state
from maskbit_tpu.losses.mlm import MLMLossConfig as JaxMLMLossConfig
from maskbit_tpu.losses.vqgan import VQGANLossConfig as JaxLossConfig
from maskbit_tpu.models.generator import LFQBert as JaxLFQBert
from maskbit_tpu.models.tokenizer import ConvVQModel as JaxConvVQModel
from maskbit_tpu.nn import pallas_attention
from maskbit_tpu.nn.discriminator import NLayerDiscriminatorv2 as JaxDiscriminator
from maskbit_tpu.train import generator_trainer as jax_gen_trainer
from maskbit_tpu.train import tokenizer_trainer as jax_tok_trainer
from maskbit_tpu_torch.cli import system_check as sc
from maskbit_tpu_torch.compat.weights import (
    discriminator_from_flax,
    generator_from_flax,
    tokenizer_from_flax,
)
from maskbit_tpu_torch.losses.mlm import MLMLossConfig
from maskbit_tpu_torch.models.generator import LFQBert
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from maskbit_tpu_torch.nn.discriminator import NLayerDiscriminatorv2
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

torch.set_num_threads(2)

TOOL_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "tools", "system_check.py")
STEPS, BATCH = 3, 4


def _tool():
    spec = importlib.util.spec_from_file_location("tools_system_check", TOOL_PATH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_synthetic_data_is_the_tools_bit_for_bit():
    tool = _tool()
    np.testing.assert_array_equal(sc.CLASS_COLORS, tool.CLASS_COLORS)
    assert sc.CLASS_COLORS.dtype == tool.CLASS_COLORS.dtype
    ours, theirs = np.random.default_rng(0), np.random.default_rng(0)
    for batch in (sc.BATCH, 3):
        got, want = sc.make_batch(ours, batch), tool.make_batch(theirs, batch)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(sc.quadrant_means(got[0]), tool.quadrant_means(want[0]))
    assert (sc.RES, sc.NCLASS, sc.BATCH) == (tool.RES, tool.NCLASS, tool.BATCH)


def test_three_stage1_steps_at_the_tools_widths_match_jax():
    losses = sc.TOOL_LOSS._replace(discriminator_start=1)
    tok_cfg = dict(sc.TOKENIZER, entropy_loss_temperature=0.1)
    jtok = JaxConvVQModel(**tok_cfg, dtype=jnp.float32)
    jdisc = JaxDiscriminator(**sc.DISCRIMINATOR, dtype=jnp.float32)
    gen_tx, disc_tx = jax_tok_trainer.make_optimizer(2e-4), jax_tok_trainer.make_optimizer(2e-4)
    jstate = jax.jit(lambda key: jax_tok_trainer.init_tokenizer_train_state(
        jtok, jdisc, gen_tx, disc_tx, key, (BATCH, sc.RES, sc.RES, 3)))(jax.random.key(0))
    jstep = jax.jit(jax_tok_trainer.make_tokenizer_train_step(
        jtok, jdisc, gen_tx, disc_tx, JaxLossConfig(**losses._asdict())))

    model = tokenizer_from_flax(jax.tree.map(np.asarray, jstate.gen_params),
                                ConvVQModel(**tok_cfg), sc.CODEBOOK)
    disc = discriminator_from_flax(jax.tree.map(np.asarray, jstate.disc_params),
                                   NLayerDiscriminatorv2(**sc.DISCRIMINATOR))
    tstate = init_tokenizer_train_state(
        model, disc, make_optimizer(model.parameters(), get_schedule("constant", 2e-4)),
        make_optimizer(disc.parameters(), get_schedule("constant", 2e-4)))
    tstep = make_tokenizer_train_step(model, disc, losses)

    rng = np.random.default_rng(0)
    for step in range(STEPS):
        images, _ = sc.make_batch(rng, BATCH)
        jstate, jm = jstep(jstate, jnp.asarray(images), None, jax.random.key(step))
        tstate, tm = tstep(tstate, torch.from_numpy(images))
        want = {k: float(v) for k, v in jm.items()}
        got = {k: float(v) for k, v in tm.items()}
        assert set(got) == set(want), set(got) ^ set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {step} {key}")
        assert (got["discriminator_loss"] != 0.0) == (step >= 1)
        assert (want["discriminator_factor"] == 1.0) == (step >= 1)
    assert tstate.disc_opt.count == STEPS - 1


def test_three_stage2_steps_at_the_tools_widths_match_jax(monkeypatch):
    run = sc.RUNS["tool"]
    depth, heads = 2, run["heads"]
    real = pallas_attention.dropout_attention
    seeds_used = []  # the (b, h) seed table of each attention call, in order

    def recording_seeds(q, k, v, seeds, rate, interpret=False):
        assert q.shape[-1] == run["hidden_dim"] // heads == 32
        jax.debug.callback(lambda s: seeds_used.append(np.asarray(s).astype(np.int64)), seeds,
                           ordered=True)
        return real(q, k, v, seeds, rate, interpret=interpret)

    monkeypatch.setattr(pallas_attention, "dropout_attention", recording_seeds)

    widths = dict(img_size=sc.RES, hidden_dim=run["hidden_dim"], codebook_size=sc.CODEBOOK,
                  codebook_splits=2, depth=depth, heads=heads, mlp_dim=run["mlp_dim"],
                  dropout=0.0, attention_dropout=0.1, fused_attention_dropout=True,
                  nclass=sc.NCLASS, input_stride=2)
    jgen = JaxLFQBert(**widths, dtype=jnp.float32)
    jtok = JaxConvVQModel(**sc.TOKENIZER, dtype=jnp.float32)
    tok_vars = jax.jit(jtok.init)(jax.random.key(0), jnp.zeros((1, sc.RES, sc.RES, 3)))
    tx = jax_tok_trainer.make_optimizer(run["lr"])
    jstate = jax.jit(lambda k: jax_gen_trainer.init_generator_train_state(jgen, tx, k))(
        jax.random.key(1))
    ema = {"decay": 0.995}
    jstep = jax_gen_trainer.make_generator_train_step(jgen, jtok, tx, JaxMLMLossConfig(),
                                                      "arccos", 0.1, ema)

    tgen = generator_from_flax(jax.tree.map(np.asarray, {"params": jstate.params}),
                               LFQBert(**widths))
    ttok = tokenizer_from_flax(jax.tree.map(np.asarray, tok_vars), ConvVQModel(**sc.TOKENIZER),
                               sc.CODEBOOK)
    opt = make_optimizer(tgen.parameters(), get_schedule("constant", run["lr"]))
    tstate = init_generator_train_state(tgen, opt)
    tstep = make_generator_train_step(tgen, ttok, MLMLossConfig(), "arccos", 0.1, ema)

    seq = jgen.seq_len
    assert seq + 1 == 257
    jstep = jax.jit(jstep)
    rng = np.random.default_rng(0)
    for step in range(STEPS):
        images, labels = sc.make_batch(rng, BATCH)
        key = jax.random.key(1000 + step)
        # the draws the JAX step makes from `key` (generator_trainer._mlm_step_core)
        rng_mask, rng_drop, _ = jax.random.split(key, 3)
        key_r, key_mask = jax.random.split(rng_mask)
        injected = {
            "mask_ratio_uniform": np.array(jax.random.uniform(key_r, (BATCH,))),
            "mask_token_uniform": np.array(jax.random.uniform(key_mask, (BATCH, seq, 2))),
            "label_drop_uniform": np.array(jax.random.uniform(rng_drop, (BATCH,))),
        }
        jstate, jm = jstep(jstate, tok_vars, jnp.asarray(images), jnp.asarray(labels), key)
        jax.effects_barrier()
        # the seeds JAX's step drew for each layer's kernel call
        assert len(seeds_used) == (step + 1) * depth
        injected["attention_seeds"] = seeds_used[step * depth:]
        tstate, tm = tstep(tstate, torch.from_numpy(images), torch.from_numpy(labels),
                           injected=injected)
        np.testing.assert_array_equal(tm["_input_tokens"].numpy(), np.asarray(jm["_input_tokens"]))
        np.testing.assert_allclose(tm["mlm_loss"].item(), float(jm["mlm_loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
        want = export_generator_state(jax.tree.map(np.asarray, jstate.params), 2)
        want_ema = export_generator_state(jax.tree.map(np.asarray, jstate.ema.params), 2)
        for name, p in tgen.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name], atol=2e-6, rtol=0,
                                       err_msg=f"step {step}: {name}")
            np.testing.assert_allclose(tstate.ema.params[name].numpy(), want_ema[name],
                                       atol=2e-6, rtol=0, err_msg=f"step {step}: EMA {name}")


def test_whole_check_rehearses_on_the_cpu():
    lines = []
    got = sc.run_check("cpu", rehearsal=True, log=lines.append)
    tok = got["tokenizer"]
    assert np.isfinite([tok["recon_first"], tok["recon_last"]]).all()
    assert tok["passed"] == (tok["recon_last"] < sc.RECON_RATIO * tok["recon_first"])
    assert set(got["runs"]) == {"tool", "flagship"}
    for name, r in got["runs"].items():
        assert r["head_dim"] == {"tool": 32, "flagship": 64}[name]
        assert r["depth"] == {"tool": 4, "flagship": 1}[name]
        assert r["finite"] and r["shape"] == [30, sc.RES, sc.RES, 3]
        assert np.isfinite([r["mlm_loss"], r["masked_acc"], r["matched"], r["chance"]]).all()
        assert r["passed"] == (r["matched"] < sc.MATCH_RATIO * r["chance"])
        # the CPU runs the plain versions: no kernel launch is counted
        assert r["launches_train"]["dropout_attention_fwd"] == 0
        assert r["launches_sample"]["attention_block"] == 0
    assert any("quadrant-color MSE" in line for line in lines)
