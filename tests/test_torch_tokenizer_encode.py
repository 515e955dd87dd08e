"""Port parity: ConvEncoder, the LFQ quantize and `tokenize` against JAX.

The JAX tokenizer's parameters are exported and loaded strictly into the
port. Float32 on both sides; latents agree to atol 1e-4 (different
convolution and GroupNorm summation orders), tokens exactly wherever no
latent lies within that tolerance of the sign boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from maskbit_tpu.models.tokenizer import ConvVQModel as JaxConvVQModel
from maskbit_tpu_torch.compat.weights import tokenizer_from_flax
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from maskbit_tpu_torch.nn.conv import same_pad
from tests.test_cli_eval_demo import TINY_VQ

torch.set_num_threads(2)


def _pair(cfg, res):
    jmodel = JaxConvVQModel.from_config(cfg)
    variables = jmodel.init(jax.random.key(7), jnp.zeros((1, res, res, 3)))
    tmodel = ConvVQModel.from_config(cfg).eval()
    tokenizer_from_flax(jax.tree.map(np.asarray, variables), tmodel, cfg["codebook_size"])
    return jmodel, variables, tmodel


@pytest.mark.parametrize("cfg,res", [
    (TINY_VQ, 32),
    (dict(TINY_VQ, num_resolutions=3, channel_mult=[1, 1, 2]), 24),  # 24 -> 12 -> 6
    (dict(TINY_VQ, sample_with_conv=False), 32),  # average-pool downsampling
])
def test_encoder_and_tokenize_match_jax(cfg, res):
    jmodel, variables, tmodel = _pair(cfg, res)
    images = np.random.default_rng(res).uniform(size=(2, res, res, 3)).astype(np.float32)
    want_z = jmodel.apply(variables, jnp.asarray(images),
                          method=lambda m, x: m.encoder(x))  # NHWC latents
    want_tokens = jmodel.apply(variables, jnp.asarray(images), method="tokenize")
    x = torch.from_numpy(images)
    with torch.inference_mode():
        got_z = tmodel.encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        z_q, result = tmodel.encode(x)
        got_tokens = tmodel.tokenize(x)
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), atol=1e-4, rtol=0)
    assert got_tokens.dtype == torch.int32 and got_tokens.shape == want_tokens.shape
    clear = (np.abs(np.asarray(want_z)) > 1e-4).all(-1)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got_tokens.numpy()[clear], np.asarray(want_tokens)[clear])
    np.testing.assert_array_equal(result["min_encoding_indices"].numpy(), got_tokens.numpy())
    assert set(np.unique(z_q.numpy())) <= {-1.0, 1.0}


def test_stride2_same_padding_is_asymmetric():
    """XLA's SAME for a stride-2 3x3 conv on an even input pads (0, 1); a
    symmetric pad of 1 samples other positions and gives other values."""
    x = torch.randn(1, 2, 8, 8, generator=torch.Generator().manual_seed(0))
    w = torch.randn(3, 2, 3, 3, generator=torch.Generator().manual_seed(1))
    padded = same_pad(x, 3, 2)
    assert padded.shape[-2:] == (9, 9)
    torch.testing.assert_close(padded[..., :8, :8], x)
    assert float(padded[..., 8, :].abs().max()) == 0 and float(padded[..., :, 8].abs().max()) == 0
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), (2, 2), "SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"))
    got = F.conv2d(padded, w, stride=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert not torch.allclose(F.conv2d(x, w, stride=2, padding=1), got, atol=1e-3)
