"""Port parity: the `Bert` generator (embedding tables, weight-tied head)
against `maskbit_tpu.models.generator.Bert` with the same weights.

* Logits over `attention_impl` einsum and fused, pre- and postnorm; the
  fused block runs in Pallas interpret mode on the JAX side and as its
  plain version on the port's CPU side. Float32, atol 1e-4 (JAX's
  polynomial erf in GELU, <= 6e-7 per activation, and other summation
  orders), as for LFQBert.
* The tied head's gradients (`tok_emb_{i}` -> `tok_emb_list.{i}.weight`,
  which takes both the input lookup's and the head's share, and
  `bias_{i}` -> `bias.{i}`) against `jax.grad`: atol 1e-5 (the gradients
  are O(1e-1); float32 sums in other orders).
* One MLM step from tokens against `make_generator_train_step_from_tokens`
  with the JAX step's draws injected and attention dropout 0.1 through the
  dropout-attention path: loss rtol 1e-5, parameters and EMA shadows atol
  2e-6, as `tests/test_torch_remat.py` holds LFQBert.
* The sampler end to end with injected draws: tokens equal, images atol
  1e-4.
* A reference-layout Bert `.bin` and a JAX `.msgpack` load strictly
  through `core.checkpoint.load_pretrained`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskbit_tpu.compat.torch_export import export_generator_state
from maskbit_tpu.core.checkpoint import save_pretrained as jax_save_pretrained
from maskbit_tpu.losses.mlm import MLMLossConfig as JaxMLMLossConfig
from maskbit_tpu.models.generator import Bert as JaxBert
from maskbit_tpu.models.tokenizer import ConvVQModel as JaxConvVQModel
from maskbit_tpu.nn import pallas_attention
from maskbit_tpu.ops.bitops import combine_factorized_tokens as jax_combine
from maskbit_tpu.sampling import sample as jsample
from maskbit_tpu.train import generator_trainer as jax_trainer
from maskbit_tpu.train.tokenizer_trainer import make_optimizer as jax_make_optimizer
from maskbit_tpu.utils.lr_schedules import get_schedule as jax_get_schedule
from maskbit_tpu_torch.compat.weights import generator_from_flax, tokenizer_from_flax
from maskbit_tpu_torch.core.checkpoint import load_pretrained
from maskbit_tpu_torch.losses.mlm import MLMLossConfig
from maskbit_tpu_torch.models.generator import Bert, init_generator_weights_, make_generator
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from maskbit_tpu_torch.nn import attention_block
from maskbit_tpu_torch.sampling import sample as tsample
from maskbit_tpu_torch.train.generator_trainer import (
    init_generator_train_state,
    make_generator_train_step_from_tokens,
)
from maskbit_tpu_torch.train.optim import make_optimizer
from maskbit_tpu_torch.utils.lr_schedules import get_schedule
from tests.test_cli_eval_demo import TINY_MLM, TINY_VQ

torch.set_num_threads(2)

TINY = dict(hidden_dim=64, codebook_size=64, codebook_splits=2, depth=2, heads=4,
            mlp_dim=128, dropout=0.0, nclass=10, input_stride=16, img_size=64)


def _pair(attention_impl="einsum", use_prenorm=False, seed=0, **extra):
    kw = dict(TINY, use_prenorm=use_prenorm, attention_impl=attention_impl, **extra)
    jmodel = JaxBert(**kw)
    variables = jax.jit(jmodel.init)(jax.random.key(seed),
                                     jnp.zeros((1, jmodel.seq_len, 2), jnp.int32),
                                     jnp.zeros((1,), jnp.int32))
    # the JAX init zeroes the per-position biases: give them values so the
    # comparisons see them
    params = jax.tree.map(np.asarray, variables)["params"]
    rng = np.random.default_rng(seed + 100)
    for i in range(2):
        params[f"bias_{i}"] = rng.normal(size=params[f"bias_{i}"].shape).astype(np.float32)
    variables = {"params": params}
    tmodel = generator_from_flax(variables, Bert(**kw).eval())
    return jmodel, variables, tmodel


def _inputs(model, b, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, model.mask_token + 1, size=(b, model.seq_len, 2)).astype(np.int32)
    labels = rng.integers(0, 10, size=(b,)).astype(np.int32)
    drop = rng.random(b) < 0.5
    return tokens, labels, drop


@pytest.mark.parametrize("attention_impl,use_prenorm", [
    ("einsum", False), ("einsum", True), ("fused", False), ("fused", True)])
def test_bert_logits_match_jax(attention_impl, use_prenorm):
    jmodel, variables, tmodel = _pair(attention_impl, use_prenorm)
    tokens, labels, drop = _inputs(tmodel, 3, seed=1)
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(tokens), jnp.asarray(labels),
                                 jnp.asarray(drop))
    before = attention_block.launches
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(tokens), torch.from_numpy(labels), torch.from_numpy(drop))
    assert attention_block.launches == before  # CPU: the plain version, no kernel
    assert got.shape == (3, tmodel.seq_len, 2, tmodel.effective_codebook_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_bert_tied_head_gradients_match_jax():
    jmodel, variables, tmodel = _pair()
    tokens, labels, drop = _inputs(tmodel, 2, seed=2)
    weights = np.random.default_rng(3).normal(
        size=(2, tmodel.seq_len, 2, tmodel.effective_codebook_size)).astype(np.float32)

    def loss(params):
        logits = jmodel.apply({"params": params}, jnp.asarray(tokens), jnp.asarray(labels),
                              jnp.asarray(drop), deterministic=True)
        return jnp.sum(logits * weights)

    jgrads = jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, variables["params"]))
    logits = tmodel(torch.from_numpy(tokens), torch.from_numpy(labels), torch.from_numpy(drop))
    (logits * torch.from_numpy(weights)).sum().backward()
    for i in range(2):
        np.testing.assert_allclose(tmodel.tok_emb_list[i].weight.grad.numpy(),
                                   np.asarray(jgrads[f"tok_emb_{i}"]["embedding"]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(tmodel.bias[i].grad.numpy(), np.asarray(jgrads[f"bias_{i}"]),
                                   atol=1e-5, rtol=0)
    # the head's share reaches only the ecs code rows; the mask row's
    # gradient comes from the input lookup alone
    assert float(tmodel.tok_emb_list[0].weight.grad[:-1].abs().sum()) > 0


def test_bert_geometry_init_and_factory():
    mlm = dict(TINY, model_cls="bert")
    model = make_generator("bert", mlm, {"codebook_size": 64})
    assert isinstance(model, Bert)
    state = model.state_dict()
    assert state["tok_emb_list.0.weight"].shape == (9, 64)  # ecs 8 + the mask token
    assert state["bias.1"].shape == (16, 8) and "prediction_layer.weight" not in state
    assert model.class_emb.weight.shape == (11, 64) and model.pos_emb.shape == (1, 17, 64)
    init_generator_weights_(model, torch.Generator().manual_seed(0))
    assert not model.bias[0].detach().any()
    assert 0.01 < float(model.tok_emb_list[1].weight.std()) < 0.03
    with pytest.raises(ValueError, match="Unknown generator"):
        make_generator("gpt", mlm, {"codebook_size": 64})


MLM = {"model_cls": "bert", "hidden_dim": 128, "depth": 2, "heads": 2, "mlp_dim": 256,
       "dropout": 0.0, "attention_dropout": 0.1, "fused_attention_dropout": True,
       "codebook_splits": 2, "use_prenorm": False, "img_size": 16, "input_stride": 2,
       "nclass": 10}
VQ = {"codebook_size": 16, "token_size": 4}
BATCH = 4
SCHEDULE = dict(name="cosine_with_minimum", base_lr=1e-3, num_warmup_steps=1,
                num_training_steps=2, minimum_rate=0.1)
OPT = dict(beta1=0.9, beta2=0.96, weight_decay=0.045, epsilon=1e-8, max_grad_norm=1.0)
EMA = {"decay": 0.9999}


def test_bert_train_step_from_tokens_matches_jax(monkeypatch):
    rng = np.random.default_rng(0)
    depth, heads = MLM["depth"], MLM["heads"]
    seed_table = rng.integers(0, 2**32, size=(depth, BATCH, heads), dtype=np.int64)
    real = pallas_attention.dropout_attention
    calls = iter(seed_table)

    def with_table_seeds(q, k, v, seeds, rate, interpret=False):
        return real(q, k, v, jnp.asarray(next(calls).astype(np.uint32)), rate, interpret=interpret)

    monkeypatch.setattr(pallas_attention, "dropout_attention", with_table_seeds)

    jgen = JaxBert.from_config(MLM, VQ)
    tx = jax_make_optimizer(jax_get_schedule(**SCHEDULE), **OPT)
    jstate = jax.jit(lambda k: jax_trainer.init_generator_train_state(jgen, tx, k))(
        jax.random.key(1))
    jstep = jax_trainer.make_generator_train_step_from_tokens(jgen, 16, tx, JaxMLMLossConfig(),
                                                              "arccos", 0.1, EMA)
    tgen = generator_from_flax(jax.tree.map(np.asarray, {"params": jstate.params}),
                               make_generator("bert", MLM, VQ))
    opt = make_optimizer(tgen.parameters(), get_schedule(**SCHEDULE), **OPT)
    tstate = init_generator_train_state(tgen, opt)
    tstep = make_generator_train_step_from_tokens(tgen, 16, MLMLossConfig(), "arccos", 0.1, EMA)

    seq = jgen.seq_len
    tokens = rng.integers(0, 16, size=(BATCH, seq)).astype(np.int32)
    labels = rng.integers(0, 10, size=(BATCH,)).astype(np.int32)
    key = jax.random.key(100)
    rng_mask, rng_drop, _ = jax.random.split(key, 3)
    key_r, key_mask = jax.random.split(rng_mask)
    injected = {
        "mask_ratio_uniform": np.array(jax.random.uniform(key_r, (BATCH,))),
        "mask_token_uniform": np.array(jax.random.uniform(key_mask, (BATCH, seq, 2))),
        "label_drop_uniform": np.array(jax.random.uniform(rng_drop, (BATCH,))),
        "attention_seeds": seed_table,
    }
    jstate, jm = jax.jit(lambda *a: jstep(*a))(jstate, jnp.asarray(tokens), jnp.asarray(labels),
                                                key)
    tstate, tm = tstep(tstate, torch.from_numpy(tokens), torch.from_numpy(labels),
                       injected=injected)
    np.testing.assert_allclose(tm["mlm_loss"].item(), float(jm["mlm_loss"]), rtol=1e-5)
    want = export_generator_state(jax.tree.map(np.asarray, jstate.params))
    want_ema = export_generator_state(jax.tree.map(np.asarray, jstate.ema.params))
    assert set(want) == {n for n, _ in tgen.named_parameters()}
    for name, p in tgen.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=2e-6, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(tstate.ema.params[name].numpy(), want_ema[name], atol=2e-6,
                                   rtol=0, err_msg=f"EMA {name}")
    assert next(calls, None) is None  # one seed row per layer call


def test_bert_sampler_end_to_end_matches_jax_chain():
    mlm = dict(TINY_MLM, model_cls="bert", num_steps=4)
    jgen = JaxBert.from_config(mlm, TINY_VQ)
    jtok = JaxConvVQModel.from_config(TINY_VQ)
    gen_vars = jax.jit(jgen.init)(jax.random.key(0), jnp.zeros((1, jgen.seq_len, 2), jnp.int32),
                                  jnp.zeros((1,), jnp.int32))
    tok_vars = jax.jit(jtok.init)(jax.random.key(1), jnp.zeros((1, 32, 32, 3)))
    tgen = generator_from_flax(jax.tree.map(np.asarray, gen_vars),
                               make_generator("bert", mlm, TINY_VQ).eval())
    ttok = tokenizer_from_flax(jax.tree.map(np.asarray, tok_vars),
                               ConvVQModel.from_config(TINY_VQ).eval(), TINY_VQ["codebook_size"])
    jcfg = jsample.SamplingConfig.from_config(mlm, TINY_VQ)
    tcfg = tsample.SamplingConfig.from_config(mlm, TINY_VQ)
    rng = np.random.default_rng(7)
    b, steps, n = 2, jcfg.num_steps, jcfg.patch_size**2
    token_draws = rng.integers(0, jcfg.mask_token, size=(steps, b, n, 2)).astype(np.int32)
    gumbel_draws = rng.gumbel(size=(steps, b, n, 2)).astype(np.float32)
    labels = np.asarray([3, 9], np.int32)

    def logits_fn(tokens, lbls, drop):
        return jgen.apply(gen_vars, tokens, lbls, drop, deterministic=True)

    jtokens, _ = jsample.sample_tokens(logits_fn, jax.random.key(0), jnp.asarray(labels), jcfg,
                                       injected=(token_draws, gumbel_draws))
    jcombined = jax_combine(jtokens, jcfg.codebook_size, jcfg.codebook_splits)
    jimages = jax.jit(lambda v, t: jtok.apply(v, t, method="decode_tokens"))(tok_vars, jcombined)
    images, tokens = tsample.make_sampler(tgen, ttok, tcfg)(
        torch.from_numpy(labels),
        injected=(torch.from_numpy(token_draws), torch.from_numpy(gumbel_draws)))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jcombined))
    np.testing.assert_allclose(images.numpy(), np.asarray(jimages), atol=1e-4, rtol=0)


def test_reference_layout_bert_loads_strictly(tmp_path):
    """The original repo's Bert keys (`tok_emb_list.{i}.weight`, `bias.{i}`)
    as a `.bin`, and the JAX package's `.msgpack` of the same weights."""
    jmodel, variables, tmodel = _pair("fused")
    state = export_generator_state(variables)
    assert {"tok_emb_list.0.weight", "tok_emb_list.1.weight", "bias.0", "bias.1"} <= set(state)
    path = str(tmp_path / "pytorch_model.bin")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in state.items()}, path)
    msgpack = str(tmp_path / "bert.msgpack")
    jax_save_pretrained(variables, msgpack)
    tokens, labels, drop = (torch.from_numpy(x) for x in _inputs(tmodel, 2, seed=4))
    with torch.inference_mode():
        want = tmodel(tokens, labels, drop)
    for source in (path, msgpack):
        model = Bert(**dict(TINY, attention_impl="fused")).eval()
        model.load_state_dict(load_pretrained(source), strict=True)
        with torch.inference_mode():
            torch.testing.assert_close(model(tokens, labels, drop), want, atol=0, rtol=0)
