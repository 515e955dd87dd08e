"""Port parity: bit-token ops exactly equal to JAX; the masking schedule
within two float32 ulps, and exact where the sampler rounds it to a count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskbit_tpu.ops import bitops as jbits
from maskbit_tpu.ops.masking import INFERENCE_MODES
from maskbit_tpu.ops.masking import get_masking_ratio as jratio
from maskbit_tpu_torch.ops import bitops as tbits
from maskbit_tpu_torch.ops.masking import get_masking_ratio as tratio

torch.set_num_threads(2)


@pytest.mark.parametrize("num_bits", [1, 5, 7, 14])
def test_bit_weights_and_codebook_exact(num_bits):
    np.testing.assert_array_equal(tbits.bit_weights(num_bits).numpy(),
                                  np.asarray(jbits.bit_weights(num_bits)))
    nb = min(num_bits, 10)
    np.testing.assert_array_equal(tbits.codebook(nb).numpy(), np.asarray(jbits.codebook(nb)))


@pytest.mark.parametrize("num_bits", [4, 7, 14])
def test_indices_bits_round_trip_exact(num_bits):
    rng = np.random.default_rng(num_bits)
    idx = rng.integers(0, 2**num_bits, size=(3, 17)).astype(np.int32)
    t_bits = tbits.indices_to_bits(torch.from_numpy(idx), num_bits)
    j_bits = jbits.indices_to_bits(jnp.asarray(idx), num_bits)
    assert t_bits.dtype == torch.float32
    np.testing.assert_array_equal(t_bits.numpy(), np.asarray(j_bits))
    # any strictly positive value is a 1-bit
    noisy = rng.normal(size=(3, 17, num_bits)).astype(np.float32)
    t_idx = tbits.bits_to_indices(torch.from_numpy(noisy))
    assert t_idx.dtype == torch.int32
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(jbits.bits_to_indices(noisy)))
    np.testing.assert_array_equal(tbits.bits_to_indices(t_bits).numpy(), idx)


@pytest.mark.parametrize("codebook_size,splits", [(16384, 2), (4096, 3), (1024, 1)])
def test_factorized_split_combine_exact(codebook_size, splits):
    rng = np.random.default_rng(splits)
    tokens = rng.integers(0, codebook_size, size=(2, 256)).astype(np.int32)
    t_split = tbits.split_factorized_tokens(torch.from_numpy(tokens), codebook_size, splits)
    j_split = jbits.split_factorized_tokens(jnp.asarray(tokens), codebook_size, splits)
    np.testing.assert_array_equal(t_split.numpy(), np.asarray(j_split))
    t_comb = tbits.combine_factorized_tokens(t_split, codebook_size, splits)
    assert t_comb.dtype == torch.int32
    np.testing.assert_array_equal(
        t_comb.numpy(), np.asarray(jbits.combine_factorized_tokens(j_split, codebook_size, splits)))
    np.testing.assert_array_equal(t_comb.numpy(), tokens)


@pytest.mark.parametrize("mode", INFERENCE_MODES)
def test_masking_ratio_matches(mode):
    """XLA's float32 cos/arccos and torch's are not correctly rounded and
    differ by an ulp or two on some inputs, so the ratio is held to 2 ulps; the
    integer the sampler takes from it, floor(ratio * num_maskable), is held
    exactly for every step of the shipped step counts and sequence lengths."""
    for steps in (2, 8, 12, 64, 128, 256):
        progress = (np.arange(steps, dtype=np.float32) + 1) / np.float32(steps)
        got = tratio(torch.from_numpy(progress), mode)
        want = np.asarray(jratio(progress, mode))
        assert got.dtype == torch.float32
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=2)
        for num_maskable in (256 * 2, 1024 * 2, 16 * 2):
            np.testing.assert_array_equal(
                np.floor(got.numpy() * num_maskable),
                np.asarray(jnp.floor(jnp.asarray(want) * num_maskable)))


def test_masking_ratio_rejects_unknown_mode():
    with pytest.raises(ValueError):
        tratio(0.5, "nope")
