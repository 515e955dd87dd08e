"""Remat (`mlm_model.remat: true`) in the port's Stage-II step, on the CPU.

* Remat on against remat off in the port, from one generator seed, with
  hidden dropout 0.3 and attention dropout 0.2 (plain softmax dropout and
  the dropout-attention path): the same loss, gradient norm and updated
  parameters, within 1e-6 as the JAX package's own remat test
  (`tests/test_trainers.py::test_generator_remat_matches_nonremat`); in
  fact bit for bit, and the step's generator ends in the same state. The
  layers really run twice: every attention and feed-forward layer's
  forward is called once more in the backward pass.
* The port's remat step against the JAX package's remat step from tokens,
  three steps on the same weights, tokens and draws, with that test's
  schedule, optimizer and tolerances (`tests/test_torch_train_step.py`:
  hidden dropout 0, attention dropout 0.1 through the dropout-attention
  path, one injected seed table per layer call; loss within rtol 1e-5,
  parameters and EMA within atol 2e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskbit_tpu.compat.torch_export import export_generator_state
from maskbit_tpu.losses.mlm import MLMLossConfig as JaxMLMLossConfig
from maskbit_tpu.models.generator import LFQBert as JaxLFQBert
from maskbit_tpu.nn import pallas_attention
from maskbit_tpu.train import generator_trainer as jax_trainer
from maskbit_tpu.train.tokenizer_trainer import make_optimizer as jax_make_optimizer
from maskbit_tpu.utils.lr_schedules import get_schedule as jax_get_schedule
from maskbit_tpu_torch.compat.weights import generator_from_flax
from maskbit_tpu_torch.losses.mlm import MLMLossConfig
from maskbit_tpu_torch.models.generator import LFQBert, init_generator_weights_
from maskbit_tpu_torch.nn.transformer import BertAttention, BertFeedForward
from maskbit_tpu_torch.train.generator_trainer import (
    init_generator_train_state,
    make_generator_train_step_from_tokens,
)
from maskbit_tpu_torch.train.optim import make_optimizer
from maskbit_tpu_torch.utils.lr_schedules import get_schedule

torch.set_num_threads(2)


def _port_step(remat, fused, injected=None, monkeypatch=None):
    model = LFQBert(img_size=16, hidden_dim=128, codebook_size=16, codebook_splits=2, depth=2,
                    heads=2, mlp_dim=64, dropout=0.0 if injected else 0.3, nclass=10,
                    input_stride=2, attention_dropout=0.2, fused_attention_dropout=fused,
                    remat=remat)
    init_generator_weights_(model, torch.Generator().manual_seed(0))
    forwards = []  # forward hooks do not fire in a checkpoint's recompute: count the calls
    for cls in (BertAttention, BertFeedForward):
        def counted(self, *args, _forward=cls.forward, **kwargs):
            forwards.append(type(self).__name__)
            return _forward(self, *args, **kwargs)

        monkeypatch.setattr(cls, "forward", counted)
    state = init_generator_train_state(model, make_optimizer(model.parameters(), lambda t: 1e-3))
    step = make_generator_train_step_from_tokens(model, 16, MLMLossConfig(),
                                                 log_param_grad_norms=True)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 16, (4, 64)))
    labels = torch.tensor([0, 1, 2, 3])
    gen = None if injected else torch.Generator().manual_seed(2)
    _, metrics = step(state, tokens, labels, gen, injected)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    monkeypatch.undo()
    return metrics, params, None if gen is None else gen.get_state(), forwards


@pytest.mark.parametrize("fused", [False, True])
def test_remat_matches_no_remat(fused, monkeypatch):
    m0, p0, g0, f0 = _port_step(False, fused, monkeypatch=monkeypatch)
    m1, p1, g1, f1 = _port_step(True, fused, monkeypatch=monkeypatch)
    assert len(f0) == 4 and len(f1) == 8  # 2 layers x (attention, FFN), twice under remat
    assert torch.equal(g0, g1)
    for k in m0:
        if not k.startswith("_"):
            assert abs(m0[k].item() - m1[k].item()) <= 1e-6, k
            assert torch.equal(m0[k], m1[k]), k
    for n in p0:
        torch.testing.assert_close(p1[n], p0[n], atol=1e-6, rtol=0)
        assert torch.equal(p0[n], p1[n]), n


def test_remat_with_injected_seeds_matches_no_remat(monkeypatch):
    rng = np.random.default_rng(5)
    injected = {"mask_ratio_uniform": rng.random(4, dtype=np.float32),
                "mask_token_uniform": rng.random((4, 64, 2), dtype=np.float32),
                "label_drop_uniform": rng.random(4, dtype=np.float32),
                "attention_seeds": rng.integers(0, 2**32, (2, 4, 2), dtype=np.int64)}
    m0, p0, _, _ = _port_step(False, True, injected, monkeypatch)
    m1, p1, _, f1 = _port_step(True, True, injected, monkeypatch)
    assert len(f1) == 8 and m0["mlm_loss"].item() == m1["mlm_loss"].item()
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n


MLM = {"model_cls": "lfq_bert", "hidden_dim": 128, "depth": 2, "heads": 2, "mlp_dim": 256,
       "dropout": 0.0, "attention_dropout": 0.1, "fused_attention_dropout": True,
       "codebook_splits": 2, "use_prenorm": False, "img_size": 16, "input_stride": 2,
       "nclass": 10, "remat": True}
VQ = {"codebook_size": 16, "token_size": 4}
BATCH, STEPS = 4, 3
SCHEDULE = dict(name="cosine_with_minimum", base_lr=1e-3, num_warmup_steps=1,
                num_training_steps=STEPS, minimum_rate=0.1)
OPT = dict(beta1=0.9, beta2=0.96, weight_decay=0.045, epsilon=1e-8, max_grad_norm=1.0)
EMA = {"decay": 0.9999}


def test_remat_step_matches_jax_remat_step(monkeypatch):
    rng = np.random.default_rng(0)
    depth, heads = MLM["depth"], MLM["heads"]
    seed_table = rng.integers(0, 2**32, size=(STEPS * depth, BATCH, heads), dtype=np.int64)
    real = pallas_attention.dropout_attention
    calls = iter(seed_table)

    def with_table_seeds(q, k, v, seeds, rate, interpret=False):
        return real(q, k, v, jnp.asarray(next(calls).astype(np.uint32)), rate, interpret=interpret)

    monkeypatch.setattr(pallas_attention, "dropout_attention", with_table_seeds)

    jgen = JaxLFQBert.from_config(MLM, VQ)
    tx = jax_make_optimizer(jax_get_schedule(**SCHEDULE), **OPT)
    jstate = jax.jit(lambda k: jax_trainer.init_generator_train_state(jgen, tx, k))(
        jax.random.key(1))
    jstep = jax_trainer.make_generator_train_step_from_tokens(jgen, 16, tx, JaxMLMLossConfig(),
                                                              "arccos", 0.1, EMA)

    tgen = generator_from_flax(jax.tree.map(np.asarray, {"params": jstate.params}),
                               LFQBert.from_config(MLM, VQ))
    assert tgen.transformer.remat
    opt = make_optimizer(tgen.parameters(), get_schedule(**SCHEDULE), **OPT)
    tstate = init_generator_train_state(tgen, opt)
    tstep = make_generator_train_step_from_tokens(tgen, 16, MLMLossConfig(), "arccos", 0.1, EMA)

    seq = jgen.seq_len
    for step in range(STEPS):
        tokens = rng.integers(0, 16, size=(BATCH, seq)).astype(np.int32)
        labels = rng.integers(0, 10, size=(BATCH,)).astype(np.int32)
        key = jax.random.key(100 + step)
        rng_mask, rng_drop, _ = jax.random.split(key, 3)
        key_r, key_mask = jax.random.split(rng_mask)
        injected = {
            "mask_ratio_uniform": np.array(jax.random.uniform(key_r, (BATCH,))),
            "mask_token_uniform": np.array(jax.random.uniform(key_mask, (BATCH, seq, 2))),
            "label_drop_uniform": np.array(jax.random.uniform(rng_drop, (BATCH,))),
            "attention_seeds": seed_table[step * depth:(step + 1) * depth],
        }
        jstate, jm = jax.jit(lambda *a: jstep(*a))(jstate, jnp.asarray(tokens),
                                                    jnp.asarray(labels), key)
        tstate, tm = tstep(tstate, torch.from_numpy(tokens), torch.from_numpy(labels),
                           injected=injected)
        np.testing.assert_allclose(tm["mlm_loss"].item(), float(jm["mlm_loss"]), rtol=1e-5)
        want = export_generator_state(jax.tree.map(np.asarray, jstate.params), 2)
        want_ema = export_generator_state(jax.tree.map(np.asarray, jstate.ema.params), 2)
        for name, p in tgen.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name], atol=2e-6, rtol=0,
                                       err_msg=f"step {step}: {name}")
            np.testing.assert_allclose(tstate.ema.params[name].numpy(), want_ema[name],
                                       atol=2e-6, rtol=0, err_msg=f"step {step}: EMA {name}")
    assert next(calls, None) is None  # one seed row per layer call, none re-drawn
