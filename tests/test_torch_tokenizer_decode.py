"""Port parity: LFQ unpack + ConvDecoder (`decode_tokens`) against JAX.

The JAX tokenizer's parameters are exported and loaded into the port's
decode-only model (decoder and quantizer strict, encoder keys skipped).
Float32 on both sides; atol 1e-4 covers the different convolution and
GroupNorm summation orders.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskbit_tpu.models.tokenizer import ConvVQModel as JaxConvVQModel
from maskbit_tpu_torch.compat.weights import tokenizer_from_flax
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from tests.test_cli_eval_demo import TINY_VQ

torch.set_num_threads(2)


def _pair(cfg, legacy):
    jmodel = JaxConvVQModel.from_config(cfg, legacy=legacy)
    variables = jmodel.init(jax.random.key(1), jnp.zeros((1, 32, 32, 3)))
    tmodel = ConvVQModel.from_config(cfg, legacy=legacy).eval()
    tokenizer_from_flax(jax.tree.map(np.asarray, variables), tmodel, cfg["codebook_size"])
    return jmodel, variables, tmodel


@pytest.mark.parametrize("legacy", [False, True])
def test_decode_tokens_matches_jax(legacy, caplog):
    with caplog.at_level(logging.INFO, logger="maskbit_tpu_torch"):
        jmodel, variables, tmodel = _pair(TINY_VQ, legacy)
    assert any("skipping" in r.message and "encoder." in r.message for r in caplog.records)
    rng = np.random.default_rng(int(legacy))
    tokens = rng.integers(0, TINY_VQ["codebook_size"], size=(2, 256)).astype(np.int32)
    want = jmodel.apply(variables, jnp.asarray(tokens), method="decode_tokens")
    with torch.inference_mode():
        got = tmodel.decode_tokens(torch.from_numpy(tokens))
    assert got.shape == (2, 32, 32, 3)  # NHWC, as in JAX
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_legacy_flag_renames_stages_only():
    _, _, plain = _pair(TINY_VQ, False)
    _, _, legacy = _pair(TINY_VQ, True)
    # stage 0 of the non-legacy decoder is the lowest-resolution one, which
    # the legacy decoder stores as up.{num_resolutions - 1}
    assert "decoder.up.0.upsample_conv.weight" in plain.state_dict()
    assert "decoder.up.1.upsample_conv.weight" in legacy.state_dict()
    assert plain.quantize.codebook.shape == (16, 4)


def test_nin_shortcut_applies_to_block_output():
    """The 1x1 shortcut takes the transformed output, not the input."""
    from maskbit_tpu_torch.nn.conv import ResidualBlock

    block = ResidualBlock(32, 64).eval()
    x = torch.randn(1, 32, 4, 4, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in block.parameters():
            p.normal_(0, 0.1, generator=torch.Generator().manual_seed(p.numel()))
        out = block(x)
        h = block.conv2(torch.nn.functional.silu(block.norm2(
            block.conv1(torch.nn.functional.silu(block.norm1(x))))))
        torch.testing.assert_close(out, h + block.nin_shortcut(h))
