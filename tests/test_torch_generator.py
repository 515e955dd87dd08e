"""Port parity: LFQBert logits against the JAX generator with the same weights.

The JAX parameters are exported (`compat/torch_export.py`) and loaded
strictly into the port. Float32 on both sides; atol 1e-4 absorbs JAX's
polynomial erf in GELU (<= 6e-7 per activation) and the different
summation orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskbit_tpu.models.generator import LFQBert as JaxLFQBert
from maskbit_tpu_torch.compat.weights import generator_from_flax
from maskbit_tpu_torch.models.generator import LFQBert
from maskbit_tpu_torch.nn import attention_block

torch.set_num_threads(2)

TINY = dict(hidden_dim=64, codebook_size=64, codebook_splits=2, depth=2, heads=4,
            mlp_dim=128, dropout=0.0, nclass=10, input_stride=16)


def _pair(img_size, attention_impl, use_prenorm, seed=0):
    kw = dict(TINY, img_size=img_size, use_prenorm=use_prenorm, attention_impl=attention_impl)
    jmodel = JaxLFQBert(**kw)
    seq = jmodel.seq_len
    variables = jmodel.init(jax.random.key(seed), jnp.zeros((1, seq, 2), jnp.int32),
                            jnp.zeros((1,), jnp.int32))
    np_tree = jax.tree.map(np.asarray, variables)
    tmodel = generator_from_flax(np_tree, LFQBert(**kw).eval())
    return jmodel, variables, tmodel


def _inputs(model, b, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, model.mask_token + 1, size=(b, model.seq_len, 2)).astype(np.int32)
    labels = rng.integers(0, 10, size=(b,)).astype(np.int32)
    drop = rng.random(b) < 0.5
    return tokens, labels, drop


@pytest.mark.parametrize("attention_impl,use_prenorm,img_size", [
    ("fused", False, 64), ("einsum", False, 64), ("einsum", True, 64),
    ("fused", True, 64), ("fused", False, 256)])
def test_lfqbert_logits_match_jax(attention_impl, use_prenorm, img_size):
    jmodel, variables, tmodel = _pair(img_size, attention_impl, use_prenorm)
    tokens, labels, drop = _inputs(tmodel, 3, seed=img_size)
    want = jmodel.apply(variables, jnp.asarray(tokens), jnp.asarray(labels),
                        jnp.asarray(drop), deterministic=True)
    before = attention_block.launches
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(tokens), torch.from_numpy(labels), torch.from_numpy(drop))
    assert attention_block.launches == before  # CPU: the plain version, no kernel
    assert got.shape == (3, tmodel.seq_len, 2, tmodel.effective_codebook_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_lfqbert_geometry_and_strict_keys():
    _, _, tmodel = _pair(64, "fused", False)
    state = tmodel.state_dict()
    assert "transformer.layers.1.0.mha.in_proj_weight" in state
    assert "last_layer.2.bias" in state and "first_layer.0.weight" in state
    assert tmodel.bits_to_indices.tolist() == [1, 2, 4]
    assert tmodel.mask_token == 8 and tmodel.pos_emb.shape == (1, 17, 64)
    assert tmodel.class_emb.weight.shape == (11, 64)  # nclass + the drop label
    with pytest.raises(RuntimeError):
        LFQBert(**dict(TINY, img_size=64, depth=1)).load_state_dict(state, strict=True)


def test_fused_route_only_in_eval_postnorm(monkeypatch):
    """BertAttention takes the fused block in eval mode, postnorm only."""
    calls = []
    real = attention_block.fused_attention_block_reference

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(attention_block, "fused_attention_block_reference", spy)
    _, _, tmodel = _pair(64, "fused", False)
    tokens, labels, drop = _inputs(tmodel, 2, seed=3)
    args = (torch.from_numpy(tokens), torch.from_numpy(labels), torch.from_numpy(drop))
    with torch.no_grad():
        tmodel(*args)
        assert len(calls) == TINY["depth"]
        tmodel.train()
        tmodel(*args)
        assert len(calls) == TINY["depth"]
