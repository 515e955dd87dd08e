"""Port parity: the perceptual backbones and LPIPS against JAX.

* `PerceptualLoss` with ResNet-50 and with ConvNeXt-S (torchvision's
  layouts; the JAX weights carried across by `perceptual_from_flax`,
  strict), on logits and on features + logits, at batch 1 from 32 px (both
  sides resize to 224 with antialiasing): the losses within rtol 1e-5 and
  the gradient of the logits loss with respect to the input within 2e-3 of
  its largest entry (float32 through 50 layers and the resize's backward,
  which sums 49 gradients into each input pixel; measured up to 9e-4).
  ConvNeXt-S uses exact-erf GELU against the JAX package's erf polynomial
  (|err| <= 1.5e-7), inside the same tolerance.
* `resize_224_bilinear` against `jax.image.resize(..., "bilinear")` from
  32, 256 and 512 px (atol 2e-6).
* `LPIPS` at 32 px, batch 2: the distances within rtol 1e-5 and the
  gradient within 1e-4 of its largest entry; `load_lpips` reads the
  shipped lin heads (`.msgpack`) and a torchvision VGG16 state dict into
  the original repo's key names (strict), and gives JAX's LPIPS built from
  the same files the same distances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskbit_tpu.losses import lpips as jax_lpips
from maskbit_tpu.losses import perceptual as jax_perceptual
from maskbit_tpu_torch.compat.weights import lpips_from_flax, perceptual_from_flax
from maskbit_tpu_torch.losses import lpips, perceptual

torch.set_num_threads(2)


def _grad_close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()) + 1e-9)


@pytest.mark.parametrize("name", ["resnet50", "convnext_s"])
def test_perceptual_loss_matches_jax(name):
    rng = np.random.default_rng(0)
    a, b = (rng.uniform(size=(1, 32, 32, 3)).astype(np.float32) for _ in range(2))
    on_logits = jax_perceptual.PerceptualLoss(model_name=name)
    on_features = jax_perceptual.PerceptualLoss(model_name=name, compute_on_logits=False)
    variables = jax.jit(on_logits.init)(jax.random.key(1), jnp.asarray(a), jnp.asarray(b))

    @jax.jit
    def reference(a, b):
        loss, grad = jax.value_and_grad(lambda a: on_logits.apply(variables, a, b))(a)
        return loss, on_features.apply(variables, a, b), grad

    want, want_features, want_grad = reference(jnp.asarray(a), jnp.asarray(b))
    tm = perceptual.PerceptualLoss(name)
    perceptual_from_flax(jax.tree.map(np.asarray, variables), tm)
    at = torch.from_numpy(a).requires_grad_()
    got = tm(at, torch.from_numpy(b))
    got.backward()
    assert not any(p.requires_grad for p in tm.parameters())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    _grad_close(at.grad.numpy(), want_grad, 2e-3)
    tm.compute_on_logits = False
    with torch.no_grad():
        got_features = tm(at, torch.from_numpy(b))
    np.testing.assert_allclose(float(got_features), float(want_features), rtol=1e-5)


@pytest.mark.parametrize("size", [32, 256, 512])
def test_resize_224_matches_jax(size):
    x = np.random.default_rng(size).uniform(size=(1, size, size, 3)).astype(np.float32)
    want = jax_perceptual.resize_224_bilinear(jnp.asarray(x))
    got = perceptual.resize_224_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=2e-6,
                               rtol=0)


def test_lpips_matches_jax():
    rng = np.random.default_rng(2)
    a, b = (rng.uniform(size=(2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    jm = jax_lpips.LPIPS()
    variables = jax.jit(jm.init)(jax.random.key(3), jnp.asarray(a), jnp.asarray(b))

    @jax.jit
    def reference(a, b):
        return (jm.apply(variables, a, b),
                jax.grad(lambda a: jnp.sum(jm.apply(variables, a, b)))(a))

    want, want_grad = reference(jnp.asarray(a), jnp.asarray(b))
    tm = lpips_from_flax(jax.tree.map(np.asarray, variables), lpips.LPIPS())
    at = torch.from_numpy(a).requires_grad_()
    got = tm(at, torch.from_numpy(b))
    got.sum().backward()
    assert got.shape == (2, 1, 1, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    _grad_close(at.grad.numpy(), want_grad, 1e-4)


def test_load_lpips_from_the_shipped_heads_and_a_vgg16_file(tmp_path):
    vgg_path = str(tmp_path / "vgg16.pth")
    state = lpips.random_vgg16_state(0)
    state["classifier.0.weight"] = torch.zeros(2, 2)  # torchvision's head: ignored
    torch.save(state, vgg_path)
    model = lpips.load_lpips(lpips.bundled_lin_weights_path(), vgg_path)
    assert "net.slice3.14.weight" in model.state_dict()
    assert "lin4.model.1.weight" in model.state_dict()
    jm = jax_lpips.LPIPS()
    variables = jax_lpips.load_lpips_params(
        str(jax_lpips.bundled_lin_weights_path()), None)
    variables["params"]["net"] = jax_lpips.convert_vgg16_features(
        {k: v.numpy() for k, v in state.items() if k.startswith("features.")})
    rng = np.random.default_rng(4)
    a, b = (rng.uniform(size=(2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    want = jm.apply(variables, jnp.asarray(a), jnp.asarray(b))
    with torch.inference_mode():
        got = model(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
