"""Port parity: the plain dropout attention (forward and backward) and the
plain dropout-free attention against the JAX package's Pallas kernels run
in interpret mode, with the same seeds; the port's keep mask against
`hash_keep_mask_np` bit for bit.

Float32 on both sides. The forward and dq/dk/dv agree to atol 5e-5,
rtol 1e-4, the tolerances of the JAX package's own replica test
(`test_dropout_attention_fwd_and_grads_match_replica`): both compute the
same f32 softmax and products, in other summation orders. Each parity test
runs at head dims 16 (the JAX package's own tests), 32 (the system check's
generator) and 64 (the flagship's): the port's kernels take every multiple
of 16 in [16, 128].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskbit_tpu.nn import pallas_attention as jax_attn
from maskbit_tpu_torch.nn import dropout_attention as da

torch.set_num_threads(2)

RATE = 0.4


def _qkv(b, n, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(3)]


def _seeds(b, h, seed):
    """uint32 seeds, half of them with the top bit set."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 2**31, size=(b, h), dtype=np.int64)
    s[:, ::2] |= 2**31
    return s.astype(np.uint32)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_hash_keep_mask_bit_identical(rate):
    seeds = [0, 1, 7919, 2**31 + 5, 2**32 - 1, 0x9E3779B1]
    n = 70
    got = da.hash_keep_mask(torch.tensor(seeds, dtype=torch.int64), n, rate).numpy()
    for i, s in enumerate(seeds):
        want = jax_attn.hash_keep_mask_np(n, rate, s)
        np.testing.assert_array_equal(got[i], want)
        np.testing.assert_array_equal(da.hash_keep_mask_np(n, rate, s), want)
    # int32 seeds carry the same bits as their uint32 values
    as_i32 = torch.tensor(np.array(seeds, dtype=np.uint32).view(np.int32))
    np.testing.assert_array_equal(da.hash_keep_mask(as_i32, n, rate).numpy(), got)
    if rate == 0.0:
        assert got.all()
    else:
        assert abs(1.0 - got.mean() - rate) < 0.05


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("n", [33, 257])
def test_dropout_attention_fwd_and_grads_match_jax(n, d):
    b, h = 2, 2
    q, k, v = _qkv(b, n, h, d, seed=n)
    seeds = _seeds(b, h, seed=n + 1)
    w0 = np.random.default_rng(n + 2).normal(size=(b, n, h, d)).astype(np.float32)

    def f_jax(q, k, v):
        return jax_attn.dropout_attention(q, k, v, jnp.asarray(seeds), RATE, interpret=True)

    want, vjp = jax.vjp(f_jax, *(jnp.asarray(x) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(w0))

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    ts = torch.from_numpy(seeds.astype(np.int64))
    before = dict(da.launches)
    got = da.dropout_attention(tq, tk, tv, ts, RATE)
    (got * torch.from_numpy(w0)).sum().backward()
    assert da.launches == before  # CPU: the plain versions, no kernel
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=5e-5, rtol=1e-4)
    for t, w in zip((tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=5e-5, rtol=1e-4)


def test_plain_backward_matches_autograd_of_plain_forward():
    """The TPU kernel's backward formula against torch autograd through the
    plain forward (float64: agreement to 1e-10 shows the formula is exact)."""
    b, n, h, d = 2, 41, 2, 64
    q, k, v = (torch.tensor(x, dtype=torch.float64, requires_grad=True)
               for x in _qkv(b, n, h, d, seed=3))
    seeds = torch.from_numpy(_seeds(b, h, seed=4).astype(np.int64))
    g = torch.randn(b, n, h, d, dtype=torch.float64, generator=torch.Generator().manual_seed(5))
    out = da.dropout_attention_reference(q, k, v, seeds, RATE)
    auto = torch.autograd.grad(out, (q, k, v), g)
    formula = da.dropout_attention_backward_reference(q.detach(), k.detach(), v.detach(), g,
                                                      seeds, RATE)
    for a, f in zip(auto, formula):
        torch.testing.assert_close(f, a, atol=1e-10, rtol=1e-10)


@pytest.mark.parametrize("d", [16, 32, 64])
def test_fused_attention_matches_jax(d):
    b, n, h = 2, 57, 2
    q, k, v = _qkv(b, n, h, d, seed=9)
    want = jax_attn.fused_attention(*(jnp.asarray(x) for x in (q, k, v)), interpret=True)
    before = dict(da.launches)
    got = da.fused_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert da.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    # rate 0 through the dropout path is the same function
    zero = da.dropout_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                torch.zeros(b, h, dtype=torch.int64), 0.0)
    torch.testing.assert_close(zero, got, atol=0, rtol=0)


def test_wrapper_rejects_bad_rate_and_seeds():
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="rate"):
        da.dropout_attention(q, q, q, torch.zeros(1, 2, dtype=torch.int64), 1.0)
    with pytest.raises(ValueError, match="seeds"):
        da.dropout_attention(q, q, q, torch.zeros(2, 2, dtype=torch.int64), 0.1)
    with pytest.raises(ValueError, match="device"):
        da.fused_attention(q.to("meta"), q.to("meta"), q.to("meta"))
