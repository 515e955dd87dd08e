"""Port parity: the TF1 resize and InceptionV3 (`eval/inception.py`) against JAX.

* `resize_bilinear_tf1` equals the JAX kernel bit for bit (256 -> 299, the
  FID case, a downsample, a non-square shape) and is the identity at 299.
* The forward: seeded random pt-fid-layout weights go into the JAX package
  through its own `convert_inception_state`, and its Flax tree comes back
  into the port through `export_inception_state` (`inception_from_flax`);
  batch 2 at 256 and 299 px, float32 on both sides, atol 1e-3 and rtol 1e-2
  (the bound of `tests/test_parity_inception.py`).
* A pt-fid-layout state dict (with `fc.bias` and the BatchNorm counters)
  loads with `strict=True`, and `full_f32` puts the caller's TF32 flags back.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskbit_tpu.eval.inception import InceptionV3 as JaxInceptionV3
from maskbit_tpu.eval.inception import convert_inception_state
from maskbit_tpu.eval.inception import resize_bilinear_tf1 as jax_resize
from maskbit_tpu_torch.compat.torch_export import export_inception_state
from maskbit_tpu_torch.compat.weights import inception_from_flax
from maskbit_tpu_torch.eval.inception import (
    InceptionV3,
    inception_from_state,
    random_inception_state,
    resize_bilinear_tf1,
)
from maskbit_tpu_torch.utils.precision import full_f32

torch.set_num_threads(2)


@pytest.mark.parametrize("in_hw,out_hw", [((256, 256), (299, 299)), ((512, 512), (299, 299)),
                                          ((300, 200), (299, 299)), ((17, 31), (29, 13))])
def test_resize_bilinear_tf1_is_bit_exact(in_hw, out_hw):
    x = np.random.default_rng(sum(in_hw)).uniform(0, 255, size=(2, *in_hw, 3)).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), *out_hw))
    got = resize_bilinear_tf1(torch.from_numpy(x), *out_hw).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_resize_bilinear_tf1_identity_and_convention():
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 255, (2, 299, 299, 3))
                         .astype(np.float32))
    assert resize_bilinear_tf1(x, 299, 299) is x
    small = torch.arange(2 * 4 * 4 * 3, dtype=torch.float32).reshape(2, 4, 4, 3)
    up = resize_bilinear_tf1(small, 8, 8)
    # src = dst * in/out, no half-pixel offset: dst 0 and 2 land on src 0 and 1
    torch.testing.assert_close(up[:, 0, 0], small[:, 0, 0], rtol=0, atol=0)
    torch.testing.assert_close(up[:, 2, 2], small[:, 1, 1], rtol=0, atol=0)


@pytest.fixture(scope="module")
def pair():
    state = random_inception_state(7)
    flax_tree = convert_inception_state({k: v.numpy() for k, v in state.items()})
    port = InceptionV3().eval()
    inception_from_flax(flax_tree, port)
    return flax_tree, port


@pytest.mark.parametrize("size", [256, 299])
def test_inception_forward_matches_jax(pair, size):
    flax_tree, port = pair
    raw = np.random.default_rng(size).uniform(0, 255, size=(2, size, size, 3)).astype(np.float32)
    want = JaxInceptionV3().apply(flax_tree, jnp.asarray(raw))
    with torch.inference_mode():
        got = port(torch.from_numpy(raw))
    for key, shape in (("2048", (2, 2048)), ("logits_unbiased", (2, 1008))):
        assert got[key].shape == shape and got[key].dtype == torch.float32
        assert np.abs(np.asarray(want[key])).max() > 1e-2  # the features do not vanish
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-3, rtol=1e-2,
                                   err_msg=f"{key} @ {size}px")


def test_export_round_trips_the_pt_fid_layout():
    state = random_inception_state(3)
    back = export_inception_state(convert_inception_state({k: v.numpy() for k, v in state.items()}))
    # JAX drops fc.bias (unused by logits_unbiased): it comes back as zeros
    assert back.keys() == state.keys()
    for key, value in state.items():
        want = np.zeros_like(value.numpy()) if key == "fc.bias" else value.numpy()
        np.testing.assert_array_equal(back[key], want, err_msg=key)


def test_pt_fid_state_dict_loads_strictly(tmp_path):
    state = random_inception_state(0)
    assert "fc.bias" in state and "Mixed_7c.branch_pool.bn.num_batches_tracked" in state
    path = tmp_path / "pt_inception.pth"
    torch.save(state, path)
    from maskbit_tpu_torch.eval.inception import load_inception_params

    model = inception_from_state(load_inception_params(str(path)), "cpu")
    assert not model.training
    for key, value in model.state_dict().items():
        assert torch.equal(value, state[key]), key
    # the counters are buffers the FID network never reads: a file without them loads too
    InceptionV3().load_state_dict(
        {k: v for k, v in state.items() if not k.endswith("num_batches_tracked")}, strict=True)


def test_full_f32_puts_the_flags_back():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with full_f32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
