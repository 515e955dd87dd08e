"""Port parity: the PatchGAN discriminators against JAX.

* `NLayerDiscriminatorv2` with the blur of 3, 4 and 5 taps (SAME padding
  at stride 2 is (0, 1), (1, 1) and (1, 2) on an even input), and with
  average pooling, at 64 px with 2 stages (so the 16x16 max pool pools):
  logits within atol 1e-4, gradient with respect to the images within 1e-4
  of its largest entry, float32 both sides, the JAX weights carried across
  (`discriminator_from_flax`, strict: the original repo's keys, the blur a
  buffer); `blur_pool_2d` alone for odd and even sizes (atol 1e-6).
* `OriginalNLayerDiscriminator`: BatchNorm by the batch's statistics, as
  the JAX step applies it; logits and input gradient likewise.
* One pass over real and fake concatenated equals two passes for the v2
  discriminator (GroupNorm is per sample), within float32 rounding (atol
  1e-5: the CPU's convolutions sum in another order at another batch).
* `init_discriminator_weights_` draws the JAX package's distributions:
  the per-tensor std of every kernel within 10% of JAX's draw (lecun
  normal, or N(0, 0.02^2) for the Pix2Pix discriminator), biases 0, norm
  scales 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskbit_tpu.nn import discriminator as jd
from maskbit_tpu_torch.compat.torch_export import export_discriminator_state
from maskbit_tpu_torch.compat.weights import discriminator_from_flax
from maskbit_tpu_torch.nn import discriminator as td

torch.set_num_threads(2)


def _grad_close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()) + 1e-7)


@pytest.mark.parametrize("blur", [3, 4, 5, None], ids=["blur3", "blur4", "blur5", "avgpool"])
def test_v2_discriminator_matches_jax(blur):
    kw = dict(hidden_channels=32, num_stages=2, blur_resample=blur is not None,
              blur_kernel_size=blur or 4)
    jm = jd.NLayerDiscriminatorv2(**kw)
    x = np.random.default_rng(0).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    variables = jax.jit(jm.init)(jax.random.key(1), jnp.asarray(x))

    @jax.jit
    def reference(x):
        return (jm.apply(variables, x),
                jax.grad(lambda x: jnp.sum(jnp.tanh(jm.apply(variables, x))))(x))

    want, want_grad = reference(jnp.asarray(x))
    tm = td.NLayerDiscriminatorv2(**kw)
    discriminator_from_flax(jax.tree.map(np.asarray, variables), tm)
    xt = torch.from_numpy(x).requires_grad_()
    got = tm(xt)
    torch.tanh(got).sum().backward()
    assert got.shape == (2, 16, 16, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0)
    _grad_close(xt.grad.numpy(), want_grad, 1e-4)
    if blur:
        assert tm.blocks[0][1].kernel.shape == (1, 1, blur, blur)


@pytest.mark.parametrize("taps", [3, 4, 5])
@pytest.mark.parametrize("size", [8, 9])
def test_blur_pool_matches_jax(taps, size):
    x = np.random.default_rng(taps + size).normal(size=(1, size, size, 4)).astype(np.float32)
    want = jd.blur_pool_2d(jnp.asarray(x), jd.BLUR_KERNEL_MAP[taps])
    got = td.blur_pool_2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                          torch.from_numpy(td.blur_kernel(td.BLUR_KERNEL_MAP[taps]))
                          ).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_original_discriminator_matches_jax():
    jm = jd.OriginalNLayerDiscriminator(hidden_channels=16, num_stages=3)
    x = np.random.default_rng(2).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    variables = jax.jit(jm.init)(jax.random.key(3), jnp.asarray(x))
    params = {"params": variables["params"]}

    def apply(x):
        out, _ = jm.apply(params, x, train=True, mutable=["batch_stats"])
        return out

    want, want_grad = jax.jit(lambda x: (apply(x), jax.grad(
        lambda x: jnp.sum(jnp.tanh(apply(x))))(x)))(jnp.asarray(x))
    tm = td.OriginalNLayerDiscriminator(hidden_channels=16, num_stages=3)
    discriminator_from_flax(jax.tree.map(np.asarray, params), tm)
    xt = torch.from_numpy(x).requires_grad_()
    got = tm(xt)
    torch.tanh(got).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0)
    _grad_close(xt.grad.numpy(), want_grad, 1e-4)
    assert not tm.main[3].running_mean.any()  # running statistics neither updated nor read


def test_concatenated_pass_equals_two_passes():
    disc = td.NLayerDiscriminatorv2(hidden_channels=32, num_stages=2, blur_resample=True)
    td.init_discriminator_weights_(disc, torch.Generator().manual_seed(0))
    a, b = (torch.rand(3, 64, 64, 3, generator=torch.Generator().manual_seed(s)) for s in (1, 2))
    with torch.no_grad():
        both = disc(torch.cat([a, b]))
        sep = torch.cat([disc(a), disc(b)])
    torch.testing.assert_close(both, sep, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cfg", [{"name": "VQGAN+Discriminator", "hidden_channels": 128,
                                  "num_stages": 4, "blur_resample": True},
                                 {"name": "Original", "hidden_channels": 64, "num_stages": 3}],
                         ids=["v2", "original"])
def test_initialisation_follows_jax(cfg):
    jm = jd.create_discriminator(cfg)
    x = jnp.zeros((1, 256, 256, 3))
    want = export_discriminator_state(
        jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(0), x)["params"]), 4)
    tm = td.create_discriminator(cfg)
    td.init_discriminator_weights_(tm, torch.Generator().manual_seed(0))
    state = tm.state_dict()
    for key, value in want.items():
        got = state[key].numpy()
        if key.endswith("weight") and value.ndim == 4:
            assert abs(got.std() / value.std() - 1.0) < 0.1, key
            assert abs(got.mean()) < 0.2 * value.std() + 1e-3, key
        elif not key.endswith(("kernel", "running_mean", "running_var", "num_batches_tracked")):
            np.testing.assert_array_equal(got, value, err_msg=key)
