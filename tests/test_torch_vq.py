"""Port parity: the VQ quantizer and the tokenizer's inference forward against JAX.

* `SimpleVectorizer` (plain and L2-normalised) on the same latents and
  codebook: indices equal, quantized latents and the commitment and codebook
  losses within float32 rounding (atol 1e-6), `get_codebook_entry` equal.
* `ConvVQModel.__call__` (reconstruction and `min_encoding_indices`) for an
  LFQ tokenizer, a VQ tokenizer and the legacy (MaskGIT) decoder, the JAX
  weights carried across with `tokenizer_from_flax` (VQ's
  `quantize/embedding` included): indices equal, reconstructions within
  atol 1e-4 (as `tests/test_torch_tokenizer_decode.py`), float32 on both
  sides; `decode_tokens` of a VQ tokenizer likewise.
* The entropy term in training mode (`train=True`, weight 0.1, T 0.5):
  every loss within rtol 1e-5 and the gradients with respect to the
  latents and the codebook within 1e-5 of their largest entries; at
  inference the term is 0.
* What is not supported is refused, as in JAX: the VAE bottleneck and an
  unknown `model_class` (the taming tokenizer, refused before it was
  ported, is held against JAX in `tests/test_torch_taming.py` and
  `tests/test_torch_eval_tokenizer_cli.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskbit_tpu.models.tokenizer import ConvVQModel as JaxConvVQModel
from maskbit_tpu.quantizers.vq import SimpleVectorizer as JaxSimpleVectorizer
from maskbit_tpu_torch.compat.weights import tokenizer_from_flax
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from maskbit_tpu_torch.quantizers.vq import SimpleVectorizer
from tests.test_cli_eval_demo import TINY_VQ

torch.set_num_threads(2)

VQ = dict(TINY_VQ, quantizer_type="lookup", codebook_size=32, token_size=16)


@pytest.mark.parametrize("l2", [False, True])
def test_simple_vectorizer_matches_jax(l2):
    rng = np.random.default_rng(int(l2))
    z = rng.normal(size=(2, 4, 4, 8)).astype(np.float32)
    codebook = rng.normal(size=(32, 8)).astype(np.float32)
    jq = JaxSimpleVectorizer(codebook_size=32, token_size=8, use_l2_normalisation=l2)
    want_z, want = jq.apply({"params": {"embedding": jnp.asarray(codebook)}}, jnp.asarray(z))
    q = SimpleVectorizer(32, 8, use_l2_normalisation=l2).eval()
    with torch.no_grad():
        q.embedding.weight.copy_(torch.from_numpy(codebook))
        got_z, got = q(torch.from_numpy(z))
    np.testing.assert_array_equal(got["min_encoding_indices"].numpy(),
                                  np.asarray(want["min_encoding_indices"]))
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), atol=1e-6, rtol=0)
    for key in ("quantizer_loss", "commitment_loss", "codebook_loss", "entropy_loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), atol=1e-6, rtol=1e-6,
                                   err_msg=key)
    idx = rng.integers(0, 32, size=(2, 5))
    np.testing.assert_allclose(
        q.get_codebook_entry(torch.from_numpy(idx)).detach().numpy(),
        np.asarray(jq.apply({"params": {"embedding": jnp.asarray(codebook)}}, jnp.asarray(idx),
                            method="get_codebook_entry")), atol=1e-6, rtol=0)


def test_straight_through_estimator_passes_gradients():
    q = SimpleVectorizer(16, 4)
    z = torch.randn(1, 2, 2, 4, generator=torch.Generator().manual_seed(0), requires_grad=True)
    z_q, result = q(z)
    (z_q.sum() + result["quantizer_loss"]).backward()
    assert torch.isfinite(z.grad).all() and q.embedding.weight.grad is not None


@pytest.mark.parametrize("cfg,legacy", [(TINY_VQ, False), (VQ, False), (VQ, True)],
                         ids=["lfq", "vq", "vq-legacy"])
def test_tokenizer_forward_matches_jax(cfg, legacy):
    jmodel = JaxConvVQModel.from_config(cfg, legacy=legacy)
    variables = jmodel.init(jax.random.key(3), jnp.zeros((1, 32, 32, 3)))
    tmodel = ConvVQModel.from_config(cfg, legacy=legacy).eval()
    tokenizer_from_flax(jax.tree.map(np.asarray, variables), tmodel, cfg["codebook_size"])
    images = np.random.default_rng(4).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    want, want_dict = jmodel.apply(variables, jnp.asarray(images))
    with torch.inference_mode():
        got, got_dict = tmodel(torch.from_numpy(images))
    np.testing.assert_array_equal(got_dict["min_encoding_indices"].numpy(),
                                  np.asarray(want_dict["min_encoding_indices"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_dict["z_quantized"].numpy(),
                               np.asarray(want_dict["z_quantized"]), atol=1e-4, rtol=0)
    if cfg["quantizer_type"] == "lookup":
        tokens = np.random.default_rng(5).integers(0, 32, size=(2, 256)).astype(np.int32)
        with torch.inference_mode():
            got = tmodel.decode_tokens(torch.from_numpy(tokens))
        want = jmodel.apply(variables, jnp.asarray(tokens), method="decode_tokens")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("l2", [False, True])
def test_vq_entropy_term_matches_jax(l2):
    rng = np.random.default_rng(10 + int(l2))
    z = rng.normal(size=(2, 4, 4, 8)).astype(np.float32)
    codebook = (rng.normal(size=(16, 8)) * 0.5).astype(np.float32)
    kw = dict(codebook_size=16, token_size=8, entropy_loss_weight=0.1,
              entropy_loss_temperature=0.5, use_l2_normalisation=l2)
    jq = JaxSimpleVectorizer(**kw)

    def jloss(z, emb):
        _, d = jq.apply({"params": {"embedding": emb}}, z, train=True)
        return d["quantizer_loss"], d

    (_, want), (want_gz, want_ge) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(z), jnp.asarray(codebook))
    q = SimpleVectorizer(16, 8, entropy_loss_weight=0.1, entropy_loss_temperature=0.5,
                         use_l2_normalisation=l2)
    with torch.no_grad():
        q.embedding.weight.copy_(torch.from_numpy(codebook))
    zt = torch.from_numpy(z).requires_grad_()
    _, got = q(zt, train=True)
    got["quantizer_loss"].backward()
    assert float(got["entropy_loss"]) != 0.0
    for key in ("quantizer_loss", "commitment_loss", "codebook_loss", "entropy_loss",
                "per_sample_entropy", "avg_entropy"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)
    for g, w in ((zt.grad, want_gz), (q.embedding.weight.grad, want_ge)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
    assert float(q(zt)[1]["entropy_loss"]) == 0.0  # inference: no entropy term


def test_what_is_not_ported_is_refused():
    from maskbit_tpu_torch.cli.eval_tokenizer import build_tokenizer
    from maskbit_tpu_torch.core.config import Config

    config = Config({"model": {"vq_model": dict(VQ, model_class="vqgan")}})
    with pytest.raises(ValueError, match="Unknown tokenizer model_class"):
        build_tokenizer(config, torch.float32)
    with pytest.raises(NotImplementedError, match="VAE"):
        ConvVQModel.from_config(dict(VQ, quantizer_type="vae"))
