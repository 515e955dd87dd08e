"""The float32 path through the Stage-II CLI, on the CPU, against JAX.

`training.mixed_precision: no` computes in float32, where the card runs the
float32 forms of the attention kernels (`csrc/attention_f32.cu`; on the CPU
their plain versions). Here the tiny LFQBert of `tests/test_torch_train_cli.py`
with `attention_impl: fused` and `fused_attention_dropout: true` (hidden
dropout 0, attention dropout 0.1) trains 2 steps from token shards through
`cli.train_maskbit.main`, with `generate_every: 2`, against the JAX
package's float32 step on the same weights, batches and draws, whose
attention runs its Pallas kernels in interpret mode:
* per step the loss within rtol 1e-5, and the saved weights and EMA within
  atol 2e-6 (`tests/test_torch_train_cli.py`'s tolerances);
* the in-training generation wrote its grid, and the EMA weights it sampled
  with give, in eval mode (the attention block on every layer: JAX's
  `fused_attention_block` kernel, the port's plain version of its float32
  chain), JAX's logits within atol 1e-4 (`tests/test_torch_generator.py`'s
  tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from maskbit_tpu.core.checkpoint import load_pretrained as jax_load_pretrained
from maskbit_tpu.core.ema import init_ema as jax_init_ema
from maskbit_tpu.losses.mlm import MLMLossConfig as JaxMLMLossConfig
from maskbit_tpu.models.generator import LFQBert as JaxLFQBert
from maskbit_tpu.nn import pallas_attention
from maskbit_tpu.train import generator_trainer as jax_trainer
from maskbit_tpu.train.tokenizer_trainer import make_optimizer as jax_make_optimizer
from maskbit_tpu.utils.lr_schedules import get_schedule as jax_get_schedule
from maskbit_tpu_torch.cli import train_maskbit
from maskbit_tpu_torch.core.checkpoint import load_pretrained, save_pretrained
from maskbit_tpu_torch.data.token_shards import TokenShardDataset, TokenShardWriter
from maskbit_tpu_torch.models.generator import LFQBert, init_generator_weights_
from tests.test_cli_eval_demo import TINY_VQ
from tests.test_torch_train_cli import TOKEN_MLM, _config

MLM = dict(TOKEN_MLM, attention_impl="fused", num_steps=2, guidance_scale=2.0)


def test_float32_step_and_generation_with_the_fused_kernels_match_jax(tmp_path, monkeypatch):
    steps, batch, seed = 2, 2, 0
    seq = (32 // 2) ** 2
    rng = np.random.default_rng(3)
    writer = TokenShardWriter(str(tmp_path / "tok-%04d.npz"), maxcount=4)
    for _ in range(3):
        writer.write_batch(rng.integers(0, 16, (2, seq)), rng.integers(0, 1000, (2,)))
    writer.close()
    token_shards = str(tmp_path / "tok-{0000..0001}.npz")
    cfg = _config(tmp_path, MLM, training={"max_train_steps": steps, "mixed_precision": "no",
                                           "num_generated_images": 2},
                  dataset={"params": {"token_shards_path_or_url": token_shards}},
                  experiment={"save_every": 100, "generate_every": 2})

    model = LFQBert.from_config(MLM, TINY_VQ)
    init_generator_weights_(model, torch.Generator().manual_seed(seed))
    save_pretrained(model, str(tmp_path / "init.bin"))
    params = jax_load_pretrained(str(tmp_path / "init.bin"))["params"]

    depth, heads = MLM["depth"], MLM["heads"]
    seed_table = rng.integers(0, 2**32, size=(steps * depth, batch, heads), dtype=np.int64)
    keys = [jax.random.key(200 + i) for i in range(steps)]
    injected = []
    for i, key in enumerate(keys):
        rng_mask, rng_drop, _ = jax.random.split(key, 3)
        key_r, key_mask = jax.random.split(rng_mask)
        injected.append({
            "mask_ratio_uniform": np.array(jax.random.uniform(key_r, (batch,))),
            "mask_token_uniform": np.array(jax.random.uniform(key_mask, (batch, seq, 2))),
            "label_drop_uniform": np.array(jax.random.uniform(rng_drop, (batch,))),
            "attention_seeds": seed_table[i * depth:(i + 1) * depth]})
    real_step = train_maskbit.make_generator_train_step_from_tokens

    def injected_step(*args, **kwargs):
        step, draws = real_step(*args, **kwargs), iter(injected)
        return lambda state, tokens, labels, gen: step(state, tokens, labels, None, next(draws))

    monkeypatch.setattr(train_maskbit, "make_generator_train_step_from_tokens", injected_step)
    result = train_maskbit.main([f"config={cfg}"])
    assert result["steps"] == steps
    out = tmp_path / "out"
    assert (out / "images" / f"train_generated-{steps:09d}.png").exists()

    real_attention = pallas_attention.dropout_attention
    calls = iter(seed_table)
    monkeypatch.setattr(pallas_attention, "dropout_attention",
                        lambda q, k, v, seeds, rate, interpret=False: real_attention(
                            q, k, v, jnp.asarray(next(calls).astype(np.uint32)), rate,
                            interpret=interpret))
    jgen = JaxLFQBert.from_config(MLM, TINY_VQ)
    tx = jax_make_optimizer(jax_get_schedule("cosine_with_minimum", 1e-3, num_warmup_steps=1,
                                             num_training_steps=steps, minimum_rate=0.1),
                            beta1=0.9, beta2=0.96, weight_decay=0.045, epsilon=1e-8,
                            max_grad_norm=1.0)
    jstate = jax_trainer.GeneratorTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                             opt=tx.init(params), ema=jax_init_ema(params))
    jstep = jax_trainer.make_generator_train_step_from_tokens(
        jgen, 16, tx, JaxMLMLossConfig(label_smoothing=0.1), "arccos", 0.1, {"decay": 0.9999})
    batches = TokenShardDataset(token_shards, resample=True, seed=seed).batches(batch)
    for i, key in enumerate(keys):
        b = next(batches)
        jstate, jm = jax.jit(lambda *a: jstep(*a))(jstate, jnp.asarray(b["tokens"]),
                                                    jnp.asarray(b["class_id"]), key)
        np.testing.assert_allclose(result["history"][i]["mlm_loss"], float(jm["mlm_loss"]),
                                   rtol=1e-5)
    assert next(calls, None) is None
    for name, tree in ((f"model-{steps}.bin", jstate.params),
                       (f"ema_model-{steps}.bin", jstate.ema.params)):
        got = jax_load_pretrained(str(out / name))["params"]
        for (path, want), have in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                      jax.tree.leaves(got), strict=True):
            np.testing.assert_allclose(np.asarray(have), np.asarray(want), atol=2e-6, rtol=0,
                                       err_msg=f"{name} {jax.tree_util.keystr(path)}")

    # the EMA weights' eval-mode logits: the attention block on every layer
    tokens = rng.integers(0, model.mask_token + 1, size=(3, model.seq_len, 2)).astype(np.int32)
    labels = np.array([4, 5, 6], np.int32)
    model.load_state_dict(load_pretrained(str(out / f"ema_model-{steps}.bin")), strict=True)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(tokens), torch.from_numpy(labels))
    want = jgen.apply({"params": jstate.ema.params}, jnp.asarray(tokens), jnp.asarray(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
