"""Port parity: three Stage-II train steps against the JAX package's.

A tiny LFQBert (depth 2, hidden 128, 2 heads, so head dim 64) with a tiny
LFQ tokenizer, hidden dropout 0.0, attention dropout 0.1 through the
dropout-attention path (`fused_attention_dropout: true`). Both frameworks
start from the same weights (the JAX ones, exported) and see the same
images and labels. The port is given the JAX step's random draws: the
masking and label-drop uniforms, computed from the JAX step's key as
`make_generator_train_step` splits it, and the per-layer attention seeds,
which this test alone substitutes on the JAX side with a wrapper of
`maskbit_tpu.nn.pallas_attention.dropout_attention` (one seed-table row per
call), the JAX package unchanged.

Float32 on both sides. Per step: loss within rtol 1e-5 and grad norm
within rtol 1e-4 (the same f32 math in other summation orders, and JAX's
polynomial erf in GELU, <= 6e-7 per activation); parameters and EMA
shadows within atol 2e-6 (the learning rate is 1e-3: Adam moves each
weight by about lr, and float32 rounding of the moments changes that
step by a few ulps of lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from maskbit_tpu.compat.torch_export import export_generator_state
from maskbit_tpu.losses.mlm import MLMLossConfig as JaxMLMLossConfig
from maskbit_tpu.models.generator import LFQBert as JaxLFQBert
from maskbit_tpu.models.tokenizer import ConvVQModel as JaxConvVQModel
from maskbit_tpu.nn import pallas_attention
from maskbit_tpu.train import generator_trainer as jax_trainer
from maskbit_tpu.train.tokenizer_trainer import make_optimizer as jax_make_optimizer
from maskbit_tpu.utils.lr_schedules import get_schedule as jax_get_schedule
from maskbit_tpu_torch.compat.weights import generator_from_flax, tokenizer_from_flax
from maskbit_tpu_torch.losses.mlm import MLMLossConfig
from maskbit_tpu_torch.models.generator import LFQBert
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from maskbit_tpu_torch.train.generator_trainer import (
    init_generator_train_state,
    make_generator_train_step,
)
from maskbit_tpu_torch.train.optim import make_optimizer
from maskbit_tpu_torch.utils.lr_schedules import get_schedule
from tests.test_cli_eval_demo import TINY_VQ

torch.set_num_threads(2)

MLM = {"model_cls": "lfq_bert", "hidden_dim": 128, "depth": 2, "heads": 2, "mlp_dim": 256,
       "dropout": 0.0, "attention_dropout": 0.1, "fused_attention_dropout": True,
       "codebook_splits": 2, "use_prenorm": False, "img_size": 16, "input_stride": 2,
       "nclass": 10}
RES, BATCH, STEPS = 16, 4, 3
SCHEDULE = dict(name="cosine_with_minimum", base_lr=1e-3, num_warmup_steps=1,
                num_training_steps=STEPS, minimum_rate=0.1)
OPT = dict(beta1=0.9, beta2=0.96, weight_decay=0.045, epsilon=1e-8, max_grad_norm=1.0)
EMA = {"decay": 0.9999}


def test_three_train_steps_match_jax(monkeypatch):
    rng = np.random.default_rng(0)
    depth, heads = MLM["depth"], MLM["heads"]
    seed_table = rng.integers(0, 2**32, size=(STEPS * depth, BATCH, heads), dtype=np.int64)

    real = pallas_attention.dropout_attention
    calls = iter(seed_table)

    def with_table_seeds(q, k, v, seeds, rate, interpret=False):
        return real(q, k, v, jnp.asarray(next(calls).astype(np.uint32)), rate, interpret=interpret)

    monkeypatch.setattr(pallas_attention, "dropout_attention", with_table_seeds)

    # JAX side
    jgen = JaxLFQBert.from_config(MLM, TINY_VQ)
    jtok = JaxConvVQModel.from_config(TINY_VQ)
    tok_vars = jax.jit(jtok.init)(jax.random.key(0), jnp.zeros((1, RES, RES, 3)))
    tx = jax_make_optimizer(jax_get_schedule(**SCHEDULE), **OPT)
    jstate = jax.jit(lambda k: jax_trainer.init_generator_train_state(jgen, tx, k))(
        jax.random.key(1))
    jstep = jax_trainer.make_generator_train_step(jgen, jtok, tx, JaxMLMLossConfig(),
                                                  "arccos", 0.1, EMA)

    # the port, from the same weights
    tgen = generator_from_flax(jax.tree.map(np.asarray, {"params": jstate.params}),
                               LFQBert.from_config(MLM, TINY_VQ))
    ttok = tokenizer_from_flax(jax.tree.map(np.asarray, tok_vars),
                               ConvVQModel.from_config(TINY_VQ), TINY_VQ["codebook_size"])
    opt = make_optimizer(tgen.parameters(), get_schedule(**SCHEDULE), **OPT)
    tstate = init_generator_train_state(tgen, opt)
    tstep = make_generator_train_step(tgen, ttok, MLMLossConfig(), "arccos", 0.1, EMA)

    seq = jgen.seq_len
    for step in range(STEPS):
        images = rng.uniform(size=(BATCH, RES, RES, 3)).astype(np.float32)
        labels = rng.integers(0, 10, size=(BATCH,)).astype(np.int32)
        key = jax.random.key(100 + step)
        # the draws the JAX step makes from `key` (generator_trainer._mlm_step_core)
        rng_mask, rng_drop, _ = jax.random.split(key, 3)
        key_r, key_mask = jax.random.split(rng_mask)
        injected = {
            "mask_ratio_uniform": np.array(jax.random.uniform(key_r, (BATCH,))),
            "mask_token_uniform": np.array(jax.random.uniform(key_mask, (BATCH, seq, 2))),
            "label_drop_uniform": np.array(jax.random.uniform(rng_drop, (BATCH,))),
            "attention_seeds": seed_table[step * depth:(step + 1) * depth],
        }
        # a fresh function per step: each trace takes this step's seed rows
        jstate, jm = jax.jit(lambda *a: jstep(*a))(jstate, tok_vars, jnp.asarray(images),
                                                    jnp.asarray(labels), key)
        tstate, tm = tstep(tstate, torch.from_numpy(images), torch.from_numpy(labels),
                           injected=injected)

        assert set(tm) == set(jm)
        np.testing.assert_array_equal(tm["_input_tokens"].numpy(), np.asarray(jm["_input_tokens"]))
        np.testing.assert_allclose(tm["mlm_loss"].item(), float(jm["mlm_loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(tm["train/masked_fraction"].item(),
                                   float(jm["train/masked_fraction"]), rtol=1e-6)
        want = export_generator_state(jax.tree.map(np.asarray, jstate.params), 2)
        want_ema = export_generator_state(jax.tree.map(np.asarray, jstate.ema.params), 2)
        for name, p in tgen.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name], atol=2e-6, rtol=0,
                                       err_msg=f"step {step}: {name}")
            np.testing.assert_allclose(tstate.ema.params[name].numpy(), want_ema[name],
                                       atol=2e-6, rtol=0, err_msg=f"step {step}: EMA {name}")
    assert next(calls, None) is None  # every seed row was used, one per layer call
