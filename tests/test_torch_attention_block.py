"""Port parity: the fused postnorm attention block.

The plain PyTorch version (which the wrapper runs for CPU tensors) is held
against the JAX block `maskbit_tpu.nn.pallas_attention.fused_attention_block`,
run in Pallas interpret mode, at atol 3e-5 / rtol 1e-4 in float32 — the
tolerance `tests/test_pallas_attention.py` holds the JAX block to. The CUDA
kernel is held against the plain version on the card in
`tests/test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskbit_tpu.nn.pallas_attention import fused_attention_block as jax_block
from maskbit_tpu_torch.nn import attention_block as ab

torch.set_num_threads(2)


def _inputs(rng, b, n, e, dtype=np.float32):
    return dict(
        x=rng.normal(size=(b, n, e)).astype(dtype),
        wqkv=(rng.normal(size=(e, 3 * e)) * 0.2).astype(dtype),
        bqkv=(rng.normal(size=(3 * e,)) * 0.1).astype(np.float32),
        wo=(rng.normal(size=(e, e)) * 0.2).astype(dtype),
        bo=(rng.normal(size=(e,)) * 0.1).astype(np.float32),
        ln_scale=(1.0 + rng.normal(size=(e,)) * 0.1).astype(np.float32),
        ln_bias=(rng.normal(size=(e,)) * 0.1).astype(np.float32),
    )


@pytest.mark.parametrize("n", [17, 257])
def test_plain_version_matches_jax_block(n):
    rng = np.random.default_rng(n)
    inp = _inputs(rng, 2, n, 64)
    want = jax_block(**{k: jnp.asarray(v) for k, v in inp.items()}, num_heads=4,
                     interpret=True)
    got = ab.fused_attention_block_reference(
        **{k: torch.from_numpy(v) for k, v in inp.items()}, num_heads=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)


def test_cpu_wrapper_dispatches_to_plain_version():
    rng = np.random.default_rng(1)
    inp = {k: torch.from_numpy(v) for k, v in _inputs(rng, 2, 33, 64).items()}
    before = ab.launches
    got = ab.fused_attention_block(**inp, num_heads=4)
    want = ab.fused_attention_block_reference(**inp, num_heads=4)
    assert ab.launches == before  # no kernel launch for CPU tensors
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_wrapper_rejects_other_devices():
    inp = {k: torch.from_numpy(v).to("meta") for k, v in
           _inputs(np.random.default_rng(2), 1, 8, 64).items()}
    with pytest.raises(ValueError, match="no kernel"):
        ab.fused_attention_block(**inp, num_heads=4)
