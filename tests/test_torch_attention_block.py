"""Port parity: the fused postnorm attention block.

The plain PyTorch version (which the wrapper runs for CPU tensors) is held
against the JAX block `maskbit_tpu.nn.pallas_attention.fused_attention_block`,
run in Pallas interpret mode, at atol 3e-5 / rtol 1e-4 in float32 — the
tolerance `tests/test_pallas_attention.py` holds the JAX block to — at head
dims 16 (E = 64 over 4 heads, the JAX tests' own block), 32 and 64, and
past 128 at 200 and 256. The
CUDA kernel is held against the plain version on the card in
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


# (2, 33, 64) over 4 heads is the block case of tests/test_pallas_attention.py
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("n", [17, 33, 257])
def test_plain_version_matches_jax_block(n, d):
    rng = np.random.default_rng(n)
    inp = _inputs(rng, 2, n, 4 * d)
    want = jax_block(**{k: jnp.asarray(v) for k, v in inp.items()}, num_heads=4,
                     interpret=True)
    got = ab.fused_attention_block_reference(
        **{k: torch.from_numpy(v) for k, v in inp.items()}, num_heads=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)


# head dims past 128, where the port's block takes the wide attention core
# (instantiated at widths 192 and 256 in bf16 and float32): 256 (E = 512
# over 2 heads) and 200 (E = 400 over 2), whose padded width 208 is
# neither an instantiation's width nor a multiple of 64-wide chunks
@pytest.mark.parametrize("e,heads", [(512, 2), (400, 2)])
def test_plain_version_matches_jax_block_past_head_dim_128(e, heads):
    rng = np.random.default_rng(e)
    inp = _inputs(rng, 1, 17, e)
    want = jax_block(**{k: jnp.asarray(v) for k, v in inp.items()}, num_heads=heads,
                     interpret=True)
    got = ab.fused_attention_block_reference(
        **{k: torch.from_numpy(v) for k, v in inp.items()}, num_heads=heads)
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


def test_plain_version_takes_bf16_vectors_as_their_f32_widening():
    """The biases and LayerNorm vectors may come in bf16, as the serving
    generator stores them: the plain version gives bit for bit what it
    gives on their f32 widening, and both match the JAX block."""
    rng = np.random.default_rng(3)
    inp = {k: torch.from_numpy(v) for k, v in _inputs(rng, 2, 33, 64).items()}
    vec = ("bqkv", "bo", "ln_scale", "ln_bias")
    narrow = {k: (v.to(torch.bfloat16) if k in vec else v) for k, v in inp.items()}
    wide = {k: (v.float() if k in vec else v) for k, v in narrow.items()}
    got = ab.fused_attention_block(**narrow, num_heads=4)
    torch.testing.assert_close(got, ab.fused_attention_block(**wide, num_heads=4), atol=0, rtol=0)
    want = jax_block(**{k: jnp.asarray(v.numpy()) for k, v in wide.items()}, num_heads=4,
                     interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("m,e,want", [
    (4112, 1024, (128, 128)),  # serving: 396 QKV blocks = 3 waves of 132
    (2050, 1024, (128, 64)),   # 512 px: 68 out-projection blocks of 128 rows: half the card
    (1, 512, (64, 64)),
    (8224, 2048, (128, 128)),
    (514, 3072, (128, 64)),
])
def test_plan_picks_block_rows_by_shape(m, e, want):
    assert ab.plan(m, e, sms=132) == want


def test_bert_attention_passes_parameters_as_stored(monkeypatch):
    """The serving layer hands the block its parameters without a cast or
    a copy (so a call on the card launches only the block's kernels)."""
    from maskbit_tpu_torch.nn import transformer

    seen = {}

    def spy(x, wqkv, bqkv, wo, bo, ln_scale, ln_bias, num_heads, eps):
        seen.update(wqkv=wqkv, bqkv=bqkv, wo=wo, bo=bo, ln_scale=ln_scale, ln_bias=ln_bias)
        return x

    monkeypatch.setattr(transformer, "fused_attention_block", spy)
    layer = transformer.BertAttention(64, 4, attention_impl="fused").to(torch.bfloat16).eval()
    with torch.no_grad():
        layer(torch.zeros(1, 5, 64, dtype=torch.bfloat16))
    mha = layer.mha
    assert seen["bqkv"] is mha.in_proj_bias and seen["bo"] is mha.out_proj.bias
    assert seen["ln_scale"] is layer.norm.weight and seen["ln_bias"] is layer.norm.bias
    assert seen["wqkv"].data_ptr() == mha.in_proj_weight.data_ptr()
    assert seen["wo"].data_ptr() == mha.out_proj.weight.data_ptr()


def _padded_block_f64(x, wqkv, bqkv, wo, bo, ln_scale, ln_bias, heads: int, d: int, e: int):
    """The plain block in float64 on inputs in `pad_block`'s layout: the
    head width read from wqkv, d's softmax scale, the LayerNorm over the
    first e columns (on unpadded inputs, the plain block itself)."""
    b, n, _ = x.shape
    dp = wqkv.shape[1] // (3 * heads)
    q, k, v = (x @ wqkv + bqkv).view(b, n, 3, heads, dp).unbind(2)
    w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * d**-0.5, dim=-1)
    attn = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, n, heads * dp)
    y = (x + attn @ wo + bo)[..., :e]
    return torch.nn.functional.layer_norm(y, (e,), ln_scale, ln_bias, eps=1e-12)


# pad_block's layout: per head, W_qkv's rows and bqkv's entries padded from d
# to d rounded up to 16 and W_o's columns likewise; x, W_qkv's and W_o's
# E-wide sides and bo padded from E to E rounded up to 8; the block on those
# inputs with d's softmax scale and the LayerNorm over the true E, sliced,
# against the unpadded block, in float64 (only the contraction lengths
# differ, which can move a sum's order: 1e-12); the unpadded float64 block is
# the plain version's function (its float32 products: 1e-4).
@pytest.mark.parametrize("e,heads", [(1152, 16), (65, 5), (40, 5), (250, 2), (80, 5)])
def test_block_padding_is_exact(e, heads):
    rng = np.random.default_rng(e)
    inp = {k: torch.from_numpy(v.astype(np.float64)) for k, v in _inputs(rng, 2, 9, e).items()}
    d, dp, ep = ab.block_widths(e, heads)
    assert (d, dp % 16, ep % 8) == (e // heads, 0, 0) and d <= dp < d + 16 and e <= ep < e + 8
    x, wqkv, bqkv, wo, bo = ab.pad_block(inp["x"], inp["wqkv"], inp["bqkv"], inp["wo"], inp["bo"],
                                         heads)
    assert x.shape == (2, 9, ep) and wqkv.shape == (ep, 3 * heads * dp)
    assert wo.shape == (heads * dp, ep) and bqkv.shape == (3 * heads * dp,) and bo.shape == (ep,)
    # the (out, in) weights the kernels read are contiguous, their padding zeros
    assert wqkv.t().is_contiguous() and wo.t().is_contiguous()
    assert not wqkv.reshape(ep, 3, heads, dp)[..., d:].any() and not wqkv[e:].any()
    assert not wo.reshape(heads, dp, ep)[:, d:].any() and not wo[:, e:].any()
    got = _padded_block_f64(x, wqkv, bqkv, wo, bo, inp["ln_scale"], inp["ln_bias"], heads, d, e)
    want = _padded_block_f64(*inp.values(), heads, d, e)
    torch.testing.assert_close(got, want, atol=1e-12, rtol=1e-12)
    plain = ab.fused_attention_block_reference(**inp, num_heads=heads)
    torch.testing.assert_close(want, plain.double(), atol=1e-4, rtol=1e-4)


# hidden 1152 over 16 heads (d = 72) trains and serves in JAX; E = 80 over 5
# heads is not a multiple of 64
@pytest.mark.parametrize("b,n,e,heads", [(1, 17, 80, 5), (2, 17, 144, 2), (1, 9, 1152, 16)])
def test_plain_version_matches_jax_block_at_other_widths(b, n, e, heads):
    rng = np.random.default_rng(e)
    inp = _inputs(rng, b, n, e)
    inp["wqkv"] *= 0.5
    want = jax_block(**{k: jnp.asarray(v) for k, v in inp.items()}, num_heads=heads,
                     interpret=True)
    got = ab.fused_attention_block(**{k: torch.from_numpy(v) for k, v in inp.items()},
                                   num_heads=heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)


def test_serving_layer_takes_the_plain_route_past_the_widest_kernel():
    """Head dim 192, past the narrow kernel templates: on the card the block
    takes it (its attention core holds the whole row, no padding, in bf16
    and in float32), while on the
    CPU the serving layer runs the plain block, as at every d, with its
    values and no kernel counted."""
    from maskbit_tpu_torch.nn import dropout_attention as da
    from maskbit_tpu_torch.nn import transformer

    assert ab.block_widths(384, 2) == (192, 192, 384)
    da.check_head_dim(192)
    assert da.head_panels(192) == [(0, 192)]
    assert da.head_panels(192, torch.float32) == [(0, 192)]
    ab.reset_launch_counts()
    layer = transformer.BertAttention(384, 2, attention_impl="fused").eval()
    with torch.no_grad():
        for i, p in enumerate(layer.parameters()):
            p.copy_(torch.from_numpy(np.random.default_rng(i).normal(size=p.shape) * 0.05))
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 9, 384)).astype(np.float32))
    with torch.no_grad():
        got = layer(x)
    counts = ab.launch_counts()
    assert counts["attention_block"] == 0 and counts["by_dtype"] == {}
    mha = layer.mha
    want = ab.fused_attention_block_reference(
        x, mha.in_proj_weight.t(), mha.in_proj_bias, mha.out_proj.weight.t(), mha.out_proj.bias,
        layer.norm.weight, layer.norm.bias, num_heads=2)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
