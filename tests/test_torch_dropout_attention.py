"""Port parity: the plain dropout attention (forward and backward) and the
plain dropout-free attention against the JAX package's Pallas kernels run
in interpret mode, with the same seeds; the port's keep mask against
`hash_keep_mask_np` bit for bit.

Float32 on both sides. The forward and dq/dk/dv agree to atol 5e-5,
rtol 1e-4, the tolerances of the JAX package's own replica test
(`test_dropout_attention_fwd_and_grads_match_replica`): both compute the
same f32 softmax and products, in other summation orders. Each parity test
runs at head dims 16 (the JAX package's own tests), 32 (the system check's
generator) and 64 (the flagship's), and at 144, 256 and 320 (n = 33), past
the narrow kernel templates: the port's kernels take every d, as the JAX
kernels do (in bf16 a block holds the whole row up to 256 and 320 takes
two 256-wide output panels).
"""

import itertools

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


# head dims past 128 at n = 33 only: the interpret-mode kernels grow with d
@pytest.mark.parametrize("n,d", [(n, d) for n in (33, 257) for d in (16, 32, 64)]
                         + [(33, 144), (33, 256), (33, 320)])
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


@pytest.mark.parametrize("d,n", [pytest.param(d, 57, id=str(d)) for d in (16, 32, 64)]
                         + [pytest.param(d, 33, id=str(d)) for d in (144, 256, 320)])
def test_fused_attention_matches_jax(d, n):
    b, h = 2, 2
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


# Head dims that are not multiples of 16 (1, 8, 72, 125): the kernels run the
# instantiation at d rounded up to 16 on inputs zero-padded per head, with
# the softmax scale of the unpadded d. In float64 the plain version at the
# padded width, sliced, equals the plain version at d: the padding adds exact
# zeros to every score and leaves zero output columns; only the contraction
# length differs, which can move a sum's order (1e-12 covers that).
@pytest.mark.parametrize("d", [1, 8, 72, 125])
def test_head_dim_padding_is_exact(d):
    b, n, h = 2, 37, 2
    dp = da.padded_head_dim(d)
    assert dp % 16 == 0 and d <= dp < d + 16
    q, k, v, g = (torch.tensor(x, dtype=torch.float64) for x in _qkv(b, n, h, d, seed=d) + [
        np.random.default_rng(d + 1).normal(size=(b, n, h, d))])
    seeds = torch.from_numpy(_seeds(b, h, seed=d + 2).astype(np.int64))
    qp, kp, vp, gp = (da._pad_heads(t, dp) for t in (q, k, v, g))
    assert qp.shape == (b, n, h, dp) and qp.is_contiguous() and not qp[..., d:].any()
    scale = d**-0.5
    close = dict(atol=1e-12, rtol=1e-12)
    torch.testing.assert_close(
        da.dropout_attention_reference(qp, kp, vp, seeds, RATE, scale)[..., :d],
        da.dropout_attention_reference(q, k, v, seeds, RATE), **close)
    for got, want in zip(da.dropout_attention_backward_reference(qp, kp, vp, gp, seeds, RATE, scale),
                         da.dropout_attention_backward_reference(q, k, v, g, seeds, RATE)):
        assert not got[..., d:].any()  # the padded columns' gradients are exact zeros
        torch.testing.assert_close(got[..., :d], want, **close)
    torch.testing.assert_close(da.fused_attention_reference(qp, kp, vp, scale)[..., :d],
                               da.fused_attention_reference(q, k, v), **close)


@pytest.mark.parametrize("d", [8, 72])
def test_dropout_attention_matches_jax_at_unpadded_head_dims(d):
    """d = 72 (hidden 1152 over 16 heads) and 8: the port's module on the
    CPU against the JAX kernels in interpret mode, forward and gradients,
    at the parity tests' tolerances (atol 5e-5, rtol 1e-4)."""
    b, n, h = 2, 33, 2
    q, k, v = _qkv(b, n, h, d, seed=d)
    seeds = _seeds(b, h, seed=d + 1)
    w0 = np.random.default_rng(d + 2).normal(size=(b, n, h, d)).astype(np.float32)

    def f_jax(q, k, v):
        return jax_attn.dropout_attention(q, k, v, jnp.asarray(seeds), RATE, interpret=True)

    want, vjp = jax.vjp(f_jax, *(jnp.asarray(x) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(w0))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    got = da.dropout_attention(tq, tk, tv, torch.from_numpy(seeds.astype(np.int64)), RATE)
    (got * torch.from_numpy(w0)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=5e-5, rtol=1e-4)
    for t, w in zip((tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=5e-5, rtol=1e-4)
    fused = jax_attn.fused_attention(*(jnp.asarray(x) for x in (q, k, v)), interpret=True)
    np.testing.assert_allclose(da.fused_attention(*(torch.from_numpy(x) for x in (q, k, v))).numpy(),
                               np.asarray(fused), atol=2e-5, rtol=1e-4)


# The panels past head dim 128 (`head_panels`): the kernels' blocks each
# write one output panel, from scores over the whole of d, on inputs
# zero-padded per head to a multiple of 16: the whole row up to d = 256 and
# panels of at most `WIDE_PANEL` columns past it, but float32's dk and dv
# (`dkdv`) in panels of at most `PANEL` columns past 128, the last narrower
# where the padded width is not a multiple of the panel. In each dtype the
# plain per-panel version over every panel of either kind, at the padded
# width and sliced to d, equals the plain whole-width version at d
# (float64; 1e-12 covers the summation orders that the padding's
# contraction length can move).
@pytest.mark.parametrize("d", [129, 200, 256, 320, 1024])
def test_head_panels_assemble_the_whole_width(d):
    b, n, h = 1, 9, 2
    dp = da.padded_head_dim(d)
    assert dp % 16 == 0 and d <= dp < d + 16
    assert da.head_panels(d) == ([(0, dp)] if d <= 256 else
                                 [(c, min(256, dp - c)) for c in range(0, dp, 256)])
    q, k, v, g = (torch.tensor(x, dtype=torch.float64) for x in _qkv(b, n, h, d, seed=d) + [
        np.random.default_rng(d + 1).normal(size=(b, n, h, d))])
    seeds = torch.from_numpy(_seeds(b, h, seed=d + 2).astype(np.int64))
    qp, kp, vp, gp = da._padded(d, q, k, v, g)
    assert qp.shape == (b, n, h, dp) and not qp[..., d:].any()
    close = dict(atol=1e-12, rtol=1e-12)
    want_out = da.dropout_attention_reference(q, k, v, seeds, RATE)
    want_grads = da.dropout_attention_backward_reference(q, k, v, g, seeds, RATE)
    want_fused = da.fused_attention_reference(q, k, v)
    assert da.head_panels(d, torch.float32) == da.head_panels(d)
    assert da.head_panels(d, torch.float32, dkdv=True) == (
        [(0, dp)] if d <= 128 else [(c, min(128, dp - c)) for c in range(0, dp, 128)])
    for dtype, dkdv in itertools.product((torch.bfloat16, torch.float32), (False, True)):
        panels = da.head_panels(d, dtype, dkdv)
        most = da.PANEL if dkdv and dtype is torch.float32 else da.WIDE_PANEL
        assert panels[0][0] == 0 and sum(w for _, w in panels) == dp
        assert all(c1 == c0 + w0 for (c0, w0), (c1, _) in zip(panels, panels[1:]))
        assert all(0 < w <= most for _, w in panels)
        parts = [da.panel_reference(qp, kp, vp, gp, seeds, RATE, panel, d**-0.5)
                 for panel in panels]
        got = [torch.cat([p[i] for p in parts], dim=-1) for i in range(4)]
        torch.testing.assert_close(got[0][..., :d], want_out, **close)
        for grad, want in zip(got[1:], want_grads):
            assert not grad[..., d:].any()
            torch.testing.assert_close(grad[..., :d], want, **close)
        fused = torch.cat([da.panel_reference(qp, kp, vp, None, None, 0.0, panel, d**-0.5)
                           for panel in panels], dim=-1)
        torch.testing.assert_close(fused[..., :d], want_fused, **close)


@pytest.mark.parametrize("d", [129, 192])
def test_plain_route_past_the_widest_kernel(d):
    """Past head dim 128 (the widest of the kernel templates' instantiations)
    the kernels take d as the JAX kernels do: the head-dim check takes it
    (only d < 1 is refused), and on the CPU the training layer takes the
    plain versions, as at every d, with their values and no kernel
    counted."""
    from maskbit_tpu_torch.nn import attention_block as ab
    from maskbit_tpu_torch.nn.transformer import DropoutRng, MultiHeadSelfAttention

    da.check_head_dim(d)
    da.check_head_dim(128)
    with pytest.raises(ValueError, match="head dim of at least 1, got 0"):
        da.check_head_dim(0)
    assert da.head_panels(d) == [(0, da.padded_head_dim(d))]
    assert da.head_panels(d, torch.float32) == [(0, da.padded_head_dim(d))]
    assert da.head_panels(d, torch.float32, dkdv=True)[-1][0] == 128
    assert da.head_panels(128) == da.head_panels(128, torch.float32, dkdv=True) == [(0, 128)]
    ab.reset_launch_counts()
    b, n, h = 2, 9, 2
    mha = MultiHeadSelfAttention(h * d, h, attention_dropout=RATE, fused_dropout=True).train()
    with torch.no_grad():
        for i, p in enumerate(mha.parameters()):
            p.copy_(torch.from_numpy(np.random.default_rng(i).normal(size=p.shape) * 0.05))
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(b, n, h * d)).astype(np.float32))
    x.requires_grad_(True)
    table = _seeds(b, h, seed=6).astype(np.int64)
    out = mha(x, DropoutRng(attention_seeds=[table]))
    out.sum().backward()
    counts = ab.launch_counts()
    assert counts["dropout_attention_fwd"] == 0 and counts["by_dtype"] == {}
    # the plain version's function
    qkv = torch.nn.functional.linear(x.detach(), mha.in_proj_weight, mha.in_proj_bias)
    q, k, v = (t.detach().requires_grad_(True) for t in qkv.view(b, n, 3, h, d).unbind(2))
    seeds = torch.from_numpy(table)
    want = da.dropout_attention_reference(q, k, v, seeds, RATE)
    torch.testing.assert_close(out, mha.out_proj(want.reshape(b, n, h * d)), atol=0, rtol=0)
    ab.reset_launch_counts()
