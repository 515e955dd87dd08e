"""Port parity: the config loader, `.bin` checkpoints, config validation
and the shared loader.

The port keeps its own copy of the JAX package's config loader
(`maskbit_tpu_torch/core/config.py`); both give equal trees for every
shipped config, with overrides, legacy aliases and interpolation.
"""

import glob
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskbit_tpu.compat.torch_export import export_generator_state, save_torch_state_dict
from maskbit_tpu.core.checkpoint import load_pretrained as jax_load_pretrained
from maskbit_tpu.core.config import load_config as jax_load_config
from maskbit_tpu.models.generator import LFQBert as JaxLFQBert
from maskbit_tpu.sampling.sample import SamplingConfig as JaxSamplingConfig
from maskbit_tpu_torch.cli.common import load_generation_models, validate_generator_config
from maskbit_tpu_torch.core.checkpoint import load_pretrained
from maskbit_tpu_torch.core.config import Config, config_from_cli, load_config
from maskbit_tpu_torch.models.generator import LFQBert
from maskbit_tpu_torch.sampling.sample import SamplingConfig
from tests.test_cli_eval_demo import DATASET, TINY_MLM, TINY_VQ

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENERATOR_CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "generator", "*.yaml")))
ALL_CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*", "*.yaml")))


@pytest.mark.parametrize("path", ALL_CONFIGS, ids=lambda p: os.path.relpath(p, ROOT))
def test_config_loader_matches_jax(path):
    overrides = ["training.per_gpu_batch_size=3", "optimizer.params.learning_rate=2e-4",
                 "serve.device=cuda", "model.mlm_model.depth=2"]
    assert load_config(path, overrides).to_dict() == jax_load_config(path, overrides).to_dict()


def test_config_interpolation_aliases_and_cli(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text("a: {lr: 1e-4, copy: '${a.lr}'}\ntraining: {per_gpu_batch_size: 4}\n")
    cfg = config_from_cli([f"config={path}", "a.lr=3e-4", "b.c=[1, 2]"])
    assert cfg.a.copy == 3e-4 and cfg.select("b.c") == [1, 2]
    assert cfg.training.per_device_batch_size == 4 and "per_gpu_batch_size" not in cfg.training
    assert cfg.select("x.y", 5) == 5 and isinstance(cfg.a, Config)
    with pytest.raises(ValueError, match="config="):
        config_from_cli(["a.b=1"])


@pytest.mark.parametrize("path", GENERATOR_CONFIGS, ids=os.path.basename)
def test_generator_configs_validate_and_sample_as_jax(path):
    """Every shipped generator config passes the port's validation and gives
    the sampling settings the JAX package derives from it."""
    from maskbit_tpu.cli.common import validate_generator_config as jax_validate

    cfg = load_config(path, ["serve.batch_size=8", "serve.device=cuda"])
    jax_validate(cfg)
    validate_generator_config(cfg)
    mlm, vq = cfg.model.mlm_model, cfg.model.vq_model
    assert tuple(SamplingConfig.from_config(mlm, vq)) == tuple(
        JaxSamplingConfig.from_config(mlm, vq))


def _tiny(**kw):
    return dict(hidden_dim=32, codebook_size=16, codebook_splits=2, depth=1, heads=2,
                mlp_dim=64, dropout=0.0, nclass=10, input_stride=16, img_size=64,
                attention_impl="fused", **kw)


def test_bin_checkpoint_with_token_emb_rename(tmp_path):
    """A zoo-style `.bin` whose input projection is named `token_emb` loads
    strictly into the port and gives the logits the JAX package computes
    from the same file."""
    jmodel = JaxLFQBert(**_tiny())
    variables = jmodel.init(jax.random.key(3), jnp.zeros((1, 16, 2), jnp.int32),
                            jnp.zeros((1,), jnp.int32))
    state = export_generator_state(jax.tree.map(np.asarray, variables), 2)
    state = {("token_emb." + k[len("input_proj."):] if k.startswith("input_proj.") else k): v
             for k, v in state.items()}
    path = str(tmp_path / "pytorch_model.bin")
    save_torch_state_dict(state, path)

    tmodel = LFQBert(**_tiny()).eval()
    loaded = load_pretrained(path)
    assert "input_proj.weight" in loaded and not any(k.startswith("token_emb") for k in loaded)
    tmodel.load_state_dict(loaded, strict=True)

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 5, size=(2, 16, 2)).astype(np.int32)
    labels = np.asarray([1, 2], np.int32)
    want = jmodel.apply(jax_load_pretrained(path), jnp.asarray(tokens),
                        jnp.asarray(labels))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(tokens), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    with pytest.raises(NotImplementedError):
        load_pretrained(str(tmp_path / "weights.msgpack"))


def _serve_cfg(**mlm):
    return Config({
        "experiment": {"vqgan_checkpoint": "", "generator_checkpoint": ""},
        "model": {"vq_model": dict(TINY_VQ), "mlm_model": dict(TINY_MLM, **mlm)},
        "dataset": DATASET,
        "training": {"mixed_precision": "bf16", "seed": 0},
    })


@pytest.mark.parametrize("bad", [dict(codebook_splits=3), dict(input_stride=4),
                                 dict(img_size=64)])
def test_validate_generator_config_matches_jax(bad):
    from maskbit_tpu.cli.common import validate_generator_config as jax_validate

    cfg = _serve_cfg(**bad)
    with pytest.raises(ValueError) as want:
        jax_validate(cfg)
    with pytest.raises(ValueError) as got:
        validate_generator_config(cfg)
    assert str(got.value) == str(want.value)
    validate_generator_config(_serve_cfg())


def test_load_generation_models_random_fallback(caplog):
    logger = logging.getLogger("maskbit_tpu_torch.test")
    with caplog.at_level(logging.WARNING, logger="maskbit_tpu_torch.test"):
        tok, gen, scfg, res, dtype = load_generation_models(_serve_cfg(), logger, "cpu",
                                                            cast_weights=True)
    assert sum("RANDOM weights" in r.message for r in caplog.records) == 2
    assert dtype == torch.bfloat16 and res == 32 and scfg.patch_size == 16
    assert not gen.training and not tok.training
    assert gen.input_proj.weight.dtype == torch.bfloat16  # cast_weights
    assert gen.input_proj.weight.float().std() > 0  # seeded random, not zeros
    assert gen.bits_to_indices.tolist() == [1, 2]  # buffers rebuilt
    assert tok.quantize.codebook.abs().min() == 1
    again = load_generation_models(_serve_cfg(), logger, "cpu")[1]
    torch.testing.assert_close(again.pos_emb, gen.pos_emb.float(), atol=1e-2, rtol=1e-2)


def test_load_generation_models_from_bin_checkpoints(tmp_path):
    """With `.bin` checkpoints present both models load strictly: the
    weights are the exported ones, the tokenizer's encoder included."""
    from maskbit_tpu.compat.torch_export import export_tokenizer_state
    from maskbit_tpu.models.tokenizer import ConvVQModel as JaxConvVQModel

    cfg = _serve_cfg()
    mlm, vq = cfg.model.mlm_model, cfg.model.vq_model
    jgen = JaxLFQBert.from_config(mlm, vq)
    gen_vars = jgen.init(jax.random.key(5), jnp.zeros((1, jgen.seq_len, 2), jnp.int32),
                         jnp.zeros((1,), jnp.int32))
    tok_vars = JaxConvVQModel.from_config(vq).init(jax.random.key(6), jnp.zeros((1, 32, 32, 3)))
    gen_state = export_generator_state(jax.tree.map(np.asarray, gen_vars), 2)
    tok_state = export_tokenizer_state(jax.tree.map(np.asarray, tok_vars), vq["codebook_size"])
    assert any(k.startswith("encoder.") for k in tok_state)
    save_torch_state_dict(gen_state, str(tmp_path / "gen.bin"))
    save_torch_state_dict(tok_state, str(tmp_path / "tok.bin"))
    tree = cfg.to_dict()
    tree["experiment"] = {"vqgan_checkpoint": str(tmp_path / "tok.bin"),
                          "generator_checkpoint": str(tmp_path / "gen.bin")}
    tree["training"]["mixed_precision"] = "no"
    tok, gen, _, _, dtype = load_generation_models(Config(tree), logging.getLogger("t"), "cpu")
    assert dtype == torch.float32
    np.testing.assert_array_equal(gen.pos_emb.detach().numpy(), gen_state["pos_emb"])
    np.testing.assert_array_equal(tok.decoder.conv_out.weight.detach().numpy(),
                                  tok_state["decoder.conv_out.weight"])
    np.testing.assert_array_equal(tok.encoder.conv_out.weight.detach().numpy(),
                                  tok_state["encoder.conv_out.weight"])
