"""Port parity: the Stage-I losses and the tokenizer's training forward against JAX.

* `ops.entropy`: `lfq_entropy_terms` at K = 10 (one dense chunk) and K = 14
  streamed in chunks of 4096 (and of 3000, rounded down to 2048), at the
  flagship's temperature 0.01: both terms within rtol 1e-5, the gradient of
  a mix of them within 1e-4 of its largest entry (T = 0.01 scales the
  logits by 200, so float32 rounding of the affinities shows up at ~3e-5
  relative in the gradient); `entropy_loss_fn` on a dense affinity within
  rtol 1e-5, its gradient within 1e-5 of the largest entry.
* `LookupFreeQuantizer` in training mode: every entry of the result dict
  (rtol 1e-5; indices equal), the straight-through output, and the
  gradient of the quantizer loss plus a linear function of the output
  (atol 1e-4 of the largest entry).
* `losses.gan`: every discriminator and generator loss, the stable sigmoid
  cross-entropy, LeCam and `adopt_weight` on the same logits (rtol 1e-6).
* `losses.vqgan`: `VQGANLossConfig.from_config`, `generator_loss` with and
  without entropy annealing and L1/L2, `nll_loss_only`,
  `discriminator_loss` with LeCam and its next state, and
  `calculate_adaptive_weight`, on the same inputs (rtol 1e-6).
* `ConvVQModel` in training mode, JAX weights carried across: the
  reconstruction and losses, and the gradients of a loss of both with
  respect to every encoder, decoder and codebook parameter (the backward
  has not run in the port before Stage I), LFQ and VQ; and
  `finetune_decoder`: the quantizer's losses are 0 and the encoder takes no
  gradient. Float32 both sides; atol 1e-4 on outputs, gradients within
  1e-4 of each parameter's largest JAX gradient entry (plus 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskbit_tpu.losses import gan as jax_gan
from maskbit_tpu.losses import vqgan as jax_vqgan
from maskbit_tpu.models.tokenizer import ConvVQModel as JaxConvVQModel
from maskbit_tpu.ops import entropy as jax_entropy
from maskbit_tpu.quantizers.lfq import LookupFreeQuantizer as JaxLFQ
from maskbit_tpu_torch.compat.torch_export import export_tokenizer_state
from maskbit_tpu_torch.compat.weights import tokenizer_from_flax
from maskbit_tpu_torch.losses import gan, vqgan
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from maskbit_tpu_torch.ops import entropy
from maskbit_tpu_torch.quantizers.lfq import LookupFreeQuantizer
from tests.test_cli_eval_demo import TINY_VQ

torch.set_num_threads(2)


def _grad_close(got, want, rel, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()) + 1e-6, err_msg=what)


@pytest.mark.parametrize("bits,rows,chunk", [(10, 64, 4096), (14, 128, 4096), (14, 128, 3000)],
                         ids=["K10-dense", "K14-chunk4096", "K14-chunk3000"])
def test_lfq_entropy_terms_match_jax(bits, rows, chunk):
    z = (np.random.default_rng(bits).normal(size=(rows // 16, 4, 4, bits)) * 0.05).astype(np.float32)

    def mix(terms):
        return 0.3 * terms[0] - 0.7 * terms[1]

    fn = jax.jit(lambda z: jax_entropy.lfq_entropy_terms(z, bits, 0.01, 0.5, chunk))
    want = fn(jnp.asarray(z))
    want_grad = jax.jit(jax.grad(lambda z: mix(fn(z))))(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_()
    got = entropy.lfq_entropy_terms(zt, bits, 0.01, 0.5, chunk)
    mix(got).backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    _grad_close(zt.grad.numpy(), want_grad, 1e-4)


def test_entropy_loss_fn_matches_jax():
    aff = np.random.default_rng(3).normal(size=(2, 3, 3, 32)).astype(np.float32)
    want = jax_entropy.entropy_loss_fn(jnp.asarray(aff), 0.5, 0.8)
    want_grad = jax.grad(lambda a: sum(jax_entropy.entropy_loss_fn(a, 0.5, 0.8)))(jnp.asarray(aff))
    at = torch.from_numpy(aff).requires_grad_()
    got = entropy.entropy_loss_fn(at, 0.5, 0.8)
    sum(got).backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    _grad_close(at.grad.numpy(), want_grad, 1e-5)
    x = np.array([0.0, 1e-6, 0.5], np.float32)
    np.testing.assert_allclose(entropy.clamp_log(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_entropy.clamp_log(jnp.asarray(x))), rtol=1e-6)


def test_lfq_training_forward_matches_jax():
    kw = dict(commitment_cost=0.25, entropy_loss_weight=0.02, entropy_loss_temperature=0.01,
              entropy_gamma=1.0, entropy_chunk_size=64)
    z = (np.random.default_rng(5).normal(size=(2, 4, 4, 8)) * 0.1).astype(np.float32)
    w = np.random.default_rng(6).normal(size=z.shape).astype(np.float32)
    jq = JaxLFQ(token_bits=8, **kw)

    def jloss(z):
        zq, d = jq.apply({}, z, train=True)
        return d["quantizer_loss"] + jnp.sum(zq * w), (zq, d)

    (_, (want_zq, want)), want_grad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(z))
    q = LookupFreeQuantizer(8, **kw)
    zt = torch.from_numpy(z).requires_grad_()
    got_zq, got = q(zt, train=True)
    (got["quantizer_loss"] + (got_zq * torch.from_numpy(w)).sum()).backward()
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["min_encoding_indices"].numpy(),
                                  np.asarray(want["min_encoding_indices"]))
    for key in ("quantizer_loss", "commitment_loss", "entropy_loss", "per_sample_entropy",
                "avg_entropy"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(got_zq.detach().numpy(), np.asarray(want_zq), atol=1e-6)
    _grad_close(zt.grad.numpy(), want_grad, 1e-4)
    _, eval_dict = q(zt)  # inference: no entropy term
    assert float(eval_dict["entropy_loss"]) == 0.0 == float(eval_dict["per_sample_entropy"])


def test_gan_losses_match_jax():
    rng = np.random.default_rng(7)
    real, fake = (rng.normal(size=(2, 4, 4, 1)).astype(np.float32) * 3 for _ in range(2))
    jr, jf, tr, tf = jnp.asarray(real), jnp.asarray(fake), torch.from_numpy(real), torch.from_numpy(fake)
    for name in ("hinge", "vanilla", "non-saturating"):
        np.testing.assert_allclose(float(gan.D_LOSSES[name](tr, tf)),
                                   float(jax_gan.D_LOSSES[name](jr, jf)), rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(float(gan.G_LOSSES[name](tf)),
                                   float(jax_gan.G_LOSSES[name](jf)), rtol=1e-6, err_msg=name)
    label = (rng.random(size=real.shape) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        gan.sigmoid_cross_entropy_with_logits(tr, torch.from_numpy(label)).numpy(),
        np.asarray(jax_gan.sigmoid_cross_entropy_with_logits(jr, jnp.asarray(label))), rtol=1e-6)
    means = [torch.tensor(v) for v in (0.3, -0.2, 0.1, 0.4)]
    np.testing.assert_allclose(float(gan.compute_lecam_loss(*means)),
                               float(jax_gan.compute_lecam_loss(*[jnp.asarray(float(m))
                                                                  for m in means])), rtol=1e-6)
    for step in (0, 4, 5, 9):
        assert gan.adopt_weight(2.0, step, threshold=5) == float(jax_gan.adopt_weight(2.0, step, 5))


LOSS_CFG = {"reconstruction_weight": 4.0, "perceptual_weight": 0.1, "discriminator_weight": 0.02,
            "discriminator_start": 3, "lecam_regularization_weight": 0.001,
            "entropy_annealing_steps": 10, "entropy_annealing_factor": 2.0,
            "discriminator_loss": "hinge", "quantizer_weight": 1.0}


@pytest.mark.parametrize("overrides", [{}, {"reconstruction_loss": "l1",
                                            "entropy_annealing_factor": 0.0,
                                            "discriminator_loss": "non-saturating"}],
                         ids=["l2-annealed", "l1-nonsaturating"])
def test_vqgan_losses_match_jax(overrides):
    cfg_dict = dict(LOSS_CFG, **overrides)
    jcfg, tcfg = jax_vqgan.VQGANLossConfig.from_config(cfg_dict), vqgan.VQGANLossConfig.from_config(cfg_dict)
    assert tuple(jcfg) == tuple(tcfg)
    rng = np.random.default_rng(8)
    inputs, recons = (rng.uniform(size=(2, 8, 8, 3)).astype(np.float32) for _ in range(2))
    logits_real, logits_fake = (rng.normal(size=(2, 4, 4, 1)).astype(np.float32) for _ in range(2))
    extra = {"quantizer_loss": 0.3, "commitment_loss": 0.2, "entropy_loss": -0.05,
             "per_sample_entropy": 0.01, "avg_entropy": 2.0, "codebook_loss": 0.1}
    jperc = lambda a, b: jnp.mean((a - b) ** 2, axis=(1, 2, 3))  # noqa: E731
    tperc = lambda a, b: ((a - b) ** 2).mean(dim=(1, 2, 3))  # noqa: E731
    for step in (1, 4):
        want_total, want = jax_vqgan.generator_loss(
            jcfg, jnp.asarray(inputs), jnp.asarray(recons),
            {k: jnp.asarray(v, jnp.float32) for k, v in extra.items()}, step, jperc,
            logits_fake=jnp.asarray(logits_fake), d_weight=jnp.asarray(0.7))
        got_total, got = vqgan.generator_loss(
            tcfg, torch.from_numpy(inputs), torch.from_numpy(recons),
            {k: torch.tensor(v) for k, v in extra.items()}, step, tperc,
            logits_fake=torch.from_numpy(logits_fake), d_weight=torch.tensor(0.7))
        assert set(got) == set(want)
        np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-6)
        for key in want:
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6, atol=1e-8,
                                       err_msg=f"{step} {key}")
        lecam = vqgan.LecamState(torch.tensor(0.2), torch.tensor(-0.1))
        jlecam = jax_vqgan.LecamState(jnp.asarray(0.2), jnp.asarray(-0.1))
        want_d, want_dd, want_state = jax_vqgan.discriminator_loss(
            jcfg, jnp.asarray(logits_real), jnp.asarray(logits_fake), step, jlecam)
        got_d, got_dd, got_state = vqgan.discriminator_loss(
            tcfg, torch.from_numpy(logits_real), torch.from_numpy(logits_fake), step, lecam)
        np.testing.assert_allclose(float(got_d), float(want_d), rtol=1e-6)
        for key in want_dd:
            np.testing.assert_allclose(float(got_dd[key]), float(want_dd[key]), rtol=1e-6,
                                       atol=1e-9, err_msg=key)
        for g, w in zip(got_state, want_state):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
    np.testing.assert_allclose(
        float(vqgan.nll_loss_only(tcfg, torch.from_numpy(inputs), torch.from_numpy(recons), tperc)),
        float(jax_vqgan.nll_loss_only(jcfg, jnp.asarray(inputs), jnp.asarray(recons), jperc)),
        rtol=1e-6)
    a, b = rng.normal(size=(3, 3, 8, 3)).astype(np.float32), rng.normal(size=(3, 3, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(
        float(vqgan.calculate_adaptive_weight(torch.from_numpy(a), torch.from_numpy(b))),
        float(jax_vqgan.calculate_adaptive_weight(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    with pytest.raises(ValueError):
        vqgan.VQGANLossConfig.from_config({"discriminator_loss": "wasserstein"})


LFQ = dict(TINY_VQ, entropy_loss_weight=0.02, entropy_loss_temperature=0.01)
VQ = dict(TINY_VQ, quantizer_type="lookup", codebook_size=32, token_size=8,
          entropy_loss_weight=0.02)


@pytest.mark.parametrize("cfg,finetune", [(LFQ, False), (VQ, False), (LFQ, True)],
                         ids=["lfq", "vq", "lfq-finetune-decoder"])
def test_tokenizer_training_forward_and_gradients_match_jax(cfg, finetune):
    jmodel = JaxConvVQModel.from_config(cfg, finetune_decoder=finetune)
    variables = jax.jit(jmodel.init)(jax.random.key(9), jnp.zeros((1, 32, 32, 3)))
    images = np.random.default_rng(10).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    weights = np.random.default_rng(11).normal(size=images.shape).astype(np.float32)

    def jloss(params):
        recon, d = jmodel.apply({"params": params}, jnp.asarray(images), train=True)
        return jnp.mean(recon * weights) + d["quantizer_loss"], (recon, d)

    (_, (want_recon, want)), want_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    model = ConvVQModel.from_config(cfg, finetune_decoder=finetune)
    tokenizer_from_flax(jax.tree.map(np.asarray, variables), model, cfg["codebook_size"])
    recon, got = model(torch.from_numpy(images), train=True)
    (torch.mean(recon * torch.from_numpy(weights)) + got["quantizer_loss"]).backward()

    np.testing.assert_allclose(recon.detach().numpy(), np.asarray(want_recon), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got["min_encoding_indices"].numpy(),
                                  np.asarray(want["min_encoding_indices"]))
    for key in ("quantizer_loss", "commitment_loss", "entropy_loss", "avg_entropy"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, atol=1e-7,
                                   err_msg=key)
    if finetune:
        assert float(got["quantizer_loss"]) == 0.0 == float(got["entropy_loss"])
    want_state = export_tokenizer_state(jax.tree.map(np.asarray, want_grads),
                                        cfg["codebook_size"])
    for name, p in model.named_parameters():
        if finetune and not name.startswith("decoder."):
            assert p.grad is None, name  # the frozen encoder is out of the graph
            assert not np.abs(want_state[name]).any(), name
            continue
        _grad_close(p.grad.numpy(), want_state[name], 1e-4, name)
