"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device. The file
imports neither JAX nor the test harness's conftest, so that it runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from maskbit_tpu_torch.nn import attention_block as ab

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


def _block_inputs(b, n, e, seed):
    rng = np.random.default_rng(seed)

    def t(*shape, std=1.0):
        return torch.from_numpy((rng.normal(size=shape) * std).astype(np.float32)).cuda()

    x = torch.nn.functional.layer_norm(t(b, n, e), (e,)).bfloat16()
    # the kernel reads the torch (out, in) layout: pass transposed views
    return dict(x=x, wqkv=t(3 * e, e, std=0.02).bfloat16().t(), bqkv=t(3 * e, std=0.02),
                wo=t(e, e, std=0.02).bfloat16().t(), bo=t(e, std=0.02),
                ln_scale=1.0 + t(e, std=0.02), ln_bias=t(e, std=0.02))


@pytest.mark.parametrize("b,n,e", [(2, 257, 1024), (1, 17, 1024), (2, 1025, 1024),
                                   (3, 100, 512)])
def test_attention_block_kernel_matches_plain_version(b, n, e):
    """bf16 kernel vs the plain version in float32 on the same bf16 inputs:
    within 3e-2, about twice the half-ulp rounding of a bf16 LayerNorm
    output of magnitude below 8."""
    _card()
    inp = _block_inputs(b, n, e, seed=n)
    before = ab.launches
    got = ab.fused_attention_block(**inp, num_heads=e // 64)
    torch.cuda.synchronize()
    assert ab.launches == before + 1
    want = ab.fused_attention_block_reference(**{k: v.float() for k, v in inp.items()},
                                              num_heads=e // 64)
    assert got.dtype == torch.bfloat16 and got.shape == (b, n, e)
    assert torch.isfinite(got).all()
    assert (got.float() - want).abs().max().item() <= 3e-2


def test_attention_block_kernel_rejects_bad_inputs():
    _card()
    inp = _block_inputs(1, 17, 1024, seed=0)
    with pytest.raises(TypeError):
        ab.fused_attention_block(**dict(inp, x=inp["x"].float()), num_heads=16)
    with pytest.raises(ValueError, match="contiguous"):
        ab.fused_attention_block(**dict(inp, wqkv=inp["wqkv"].contiguous()), num_heads=16)
    with pytest.raises(ValueError, match="head dim"):
        ab.fused_attention_block(**inp, num_heads=8)
