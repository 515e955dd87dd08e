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


def _block_inputs(b, n, e, seed, vectors=torch.float32):
    rng = np.random.default_rng(seed)

    def t(*shape, std=1.0):
        return torch.from_numpy((rng.normal(size=shape) * std).astype(np.float32)).cuda()

    x = torch.nn.functional.layer_norm(t(b, n, e), (e,)).bfloat16()
    # the kernel reads the torch (out, in) layout: pass transposed views
    return dict(x=x, wqkv=t(3 * e, e, std=0.02).bfloat16().t(),
                bqkv=t(3 * e, std=0.02).to(vectors), wo=t(e, e, std=0.02).bfloat16().t(),
                bo=t(e, std=0.02).to(vectors), ln_scale=(1.0 + t(e, std=0.02)).to(vectors),
                ln_bias=t(e, std=0.02).to(vectors))


# Every tile edge of the chain: rows M = b * n of 1, 127, 128, 129, 2050 (the
# 512 px batch, 64-row blocks), 4112 (serving, 128-row blocks) and 51,400
# (eval_maskbit's CFG batch of 200); sequence
# lengths 1, 63, 64, 65, 257 and 1025 (the attention's 64-row tiles); E of
# 512 and 1024, 576 (the last 256-column block of each projection partly
# past the matrix) and 3072.
@pytest.mark.parametrize("b,n,e", [(2, 257, 1024), (1, 17, 1024), (2, 1025, 1024),
                                   (3, 100, 512), (1, 1, 1024), (1, 127, 512), (2, 64, 1024),
                                   (1, 129, 1024), (2, 63, 512), (2, 65, 576), (16, 257, 1024),
                                   (1, 1025, 512), (3, 65, 3072), (1, 257, 576),
                                   (200, 257, 1024)])
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


@pytest.mark.parametrize("b,n,e", [(16, 257, 1024), (2, 1025, 1024), (1, 129, 576)])
def test_attention_block_kernel_takes_bf16_vectors_and_repeats_bit_for_bit(b, n, e):
    """bf16 biases and LayerNorm vectors (as the serving generator stores
    them) give what their f32 widening gives, bit for bit, and so does a
    second call; one launch is counted per call."""
    _card()
    inp = _block_inputs(b, n, e, seed=3, vectors=torch.bfloat16)
    wide = {k: (v.float() if v.dim() == 1 else v) for k, v in inp.items()}
    before = ab.launches
    got = ab.fused_attention_block(**inp, num_heads=e // 64)
    again = ab.fused_attention_block(**inp, num_heads=e // 64)
    widened = ab.fused_attention_block(**wide, num_heads=e // 64)
    torch.cuda.synchronize()
    assert ab.launches == before + 3
    assert torch.equal(got, again) and torch.equal(got, widened)
    want = ab.fused_attention_block_reference(**{k: v.float() for k, v in inp.items()},
                                              num_heads=e // 64)
    assert (got.float() - want).abs().max().item() <= 3e-2


@pytest.mark.parametrize("tiles", [(128, 128), (64, 64), (128, 64), (64, 128)])
def test_attention_block_kernel_every_tile_plan(tiles):
    """Each block-row choice of both projections at E = 1024, whichever the
    plan picks for this shape, against the plain version."""
    _card()
    inp = _block_inputs(2, 257, 1024, seed=5)
    got = ab._launch(**inp, num_heads=16, eps=1e-12, tiles=tiles)
    torch.cuda.synchronize()
    want = ab.fused_attention_block_reference(**{k: v.float() for k, v in inp.items()},
                                              num_heads=16)
    assert (got.float() - want).abs().max().item() <= 3e-2


def test_attention_block_runs_only_the_ports_kernels():
    """A profile of one block call, and of one serving-mode BertAttention
    call on bf16 weights, shows only kernels built from
    maskbit_tpu_torch/csrc/: no library GEMM, attention or cast."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from maskbit_tpu_torch.nn.transformer import BertAttention

    _card()
    inp = _block_inputs(16, 257, 1024, seed=1, vectors=torch.bfloat16)
    layer = BertAttention(1024, 16, attention_impl="fused").cuda().to(torch.bfloat16).eval()
    ab.fused_attention_block(**inp, num_heads=16)
    with torch.inference_mode():
        layer(inp["x"])
    torch.cuda.synchronize()
    own = ("proj_kernel", "attn_fwd_kernel", "layernorm_kernel")
    for call in (lambda: ab.fused_attention_block(**inp, num_heads=16),
                 lambda: layer(inp["x"])):
        with torch.inference_mode(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [ev.key for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
        assert names, "the profiler saw no kernel"
        for name in names:
            assert any(k in name for k in own), name
            assert not any(k in name.lower() for k in ("gemm", "nvjet", "cutlass", "flash", "cudnn"))


def test_attention_block_kernel_rejects_bad_inputs():
    _card()
    inp = _block_inputs(1, 17, 1024, seed=0)
    with pytest.raises(TypeError):
        ab.fused_attention_block(**dict(inp, x=inp["x"].float()), num_heads=16)
    with pytest.raises(ValueError, match="contiguous"):
        ab.fused_attention_block(**dict(inp, wqkv=inp["wqkv"].contiguous()), num_heads=16)
    with pytest.raises(ValueError, match="head dim"):
        ab.fused_attention_block(**inp, num_heads=8)
    # the vectors: f32 or bf16, on x's device, of their length, contiguous
    with pytest.raises(TypeError, match="bqkv"):
        ab.fused_attention_block(**dict(inp, bqkv=inp["bqkv"].half()), num_heads=16)
    with pytest.raises(TypeError, match="ln_bias"):
        ab.fused_attention_block(**dict(inp, ln_bias=inp["ln_bias"].double()), num_heads=16)
    with pytest.raises(ValueError, match="is on"):
        ab.fused_attention_block(**dict(inp, bo=inp["bo"].cpu()), num_heads=16)
    with pytest.raises(ValueError, match="shape"):
        ab.fused_attention_block(**dict(inp, ln_scale=inp["ln_scale"][:512]), num_heads=16)
    with pytest.raises(ValueError, match="contiguous"):
        ab.fused_attention_block(**dict(inp, bo=torch.stack([inp["bo"]] * 2, 1)[:, 0]),
                                 num_heads=16)
    with pytest.raises(ValueError, match="E <= 4096"):
        e = 4160
        big = dict(x=torch.zeros(1, 1, e, device="cuda", dtype=torch.bfloat16),
                   wqkv=torch.zeros(3 * e, e, device="cuda", dtype=torch.bfloat16).t(),
                   bqkv=torch.zeros(3 * e, device="cuda"),
                   wo=torch.zeros(e, e, device="cuda", dtype=torch.bfloat16).t(),
                   bo=torch.zeros(e, device="cuda"), ln_scale=torch.ones(e, device="cuda"),
                   ln_bias=torch.zeros(e, device="cuda"))
        ab.fused_attention_block(**big, num_heads=e // 64)


def _qkv(b, n, h, seed, layout="separate"):
    """bf16 q, k, v (b, n, h, 64); "packed" gives the QKV projection's view
    of one (b, n, 3, h, 64) tensor, as the transformer passes them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "packed":
        qkv = torch.randn(b, n, 3, h, 64, generator=g, device="cuda").bfloat16()
        return qkv.unbind(2)
    return [torch.randn(b, n, h, 64, generator=g, device="cuda").bfloat16() for _ in range(3)]


def _seeds(b, h, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 2**32, (b, h), generator=g, device="cuda", dtype=torch.int64)


# The kernels return bf16; the plain versions run in float32 on the same bf16
# inputs with the same rounding points. An output of magnitude below 2 rounds
# to bf16 within 2^-8 = 0.0039; the online softmax rounds unnormalised
# weights (one more bf16 rounding, relative 2^-9, of weights that sum to at
# most 1/(1-p)) and the backward's delta = rowsum(g * out) reads the bf16
# output. 2e-2 covers these with room; one flipped mask bit moves an output
# by about |v| / n / (1-p) > 2e-2 only at small n, so the mask is checked
# separately at zero logits.
DROPOUT_ATOL = 2e-2


@pytest.mark.parametrize("b,n,h,layout", [(2, 257, 4, "packed"), (1, 33, 2, "separate"),
                                          (1, 130, 3, "packed")])
def test_dropout_attention_kernels_match_plain_versions(b, n, h, layout):
    from maskbit_tpu_torch.nn import dropout_attention as da

    _card()
    q, k, v = _qkv(b, n, h, seed=n, layout=layout)
    seeds = _seeds(b, h, seed=n + 1)
    rate = 0.1
    before = dict(da.launches)
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = da.dropout_attention(qg, kg, vg, seeds, rate)
    gout = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(7),
                       device="cuda").bfloat16()
    out.backward(gout)
    torch.cuda.synchronize()
    assert da.launches["dropout_attention_fwd"] == before["dropout_attention_fwd"] + 1
    assert da.launches["dropout_attention_bwd"] == before["dropout_attention_bwd"] + 1
    want = da.dropout_attention_reference(q.float(), k.float(), v.float(), seeds, rate)
    assert (out.float() - want).abs().max().item() <= DROPOUT_ATOL
    dq, dk, dv = da.dropout_attention_backward_reference(
        q.float(), k.float(), v.float(), gout.float(), seeds, rate)
    for got, ref in ((qg.grad, dq), (kg.grad, dk), (vg.grad, dv)):
        assert torch.isfinite(got).all()
        assert (got.float() - ref).abs().max().item() <= DROPOUT_ATOL * max(1.0, ref.abs().max().item())


def _launch_both(da, q, k, v, seeds, rate, gout):
    """The forward and backward kernels directly: out, (dq, dk, dv)."""
    seeds32 = da.seeds_as_int32(seeds, (q.shape[0], q.shape[2]))
    out, lse = da.launch_forward(q, k, v, seeds32, rate)
    return out, da.launch_backward(q, k, v, out, lse, gout, seeds32, rate)


def _check_against_plain(da, q, k, v, seeds, rate, out, grads, gout):
    # At n = 1 the output is v / (1 - rate) itself, up to about 5: its bf16
    # rounding (half an ulp, 2^-8 relative) and the kernel's bf16 rounding of
    # the weight (2^-8 relative) add 2^-7 |out| to the absolute tolerance.
    want = da.dropout_attention_reference(q.float(), k.float(), v.float(), seeds, rate)
    assert torch.isfinite(out).all()
    assert ((out.float() - want).abs() <= DROPOUT_ATOL + 2**-7 * want.abs()).all()
    refs = da.dropout_attention_backward_reference(
        q.float(), k.float(), v.float(), gout.float(), seeds, rate)
    # The kernels' delta = rowsum(g * out) reads the forward's bf16 output,
    # whose weights were rounded to bf16: dw - delta carries up to about
    # 2^-7 |g . v| / (1 - rate) per row, which reaches dq and dk through
    # d^-0.5 |k| and d^-0.5 |q|. It dominates where one key takes the whole
    # weight (n = 1, where dq and dk are 0).
    gv = (gout.float() * v.float()).sum(-1).abs().max().item() / (1.0 - rate)
    slack = [2**-7 * gv * 64**-0.5 * t.float().abs().max().item() for t in (k, q)] + [0.0]
    for got, ref, extra in zip(grads, refs, slack):
        assert torch.isfinite(got).all()
        tol = DROPOUT_ATOL * max(1.0, ref.abs().max().item()) + extra
        assert (got.float() - ref).abs().max().item() <= tol


@pytest.mark.parametrize("layout", ["packed", "separate"])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 63, 64, 65, 129, 257, 1025])
def test_dropout_attention_kernels_at_ragged_lengths(n, rate, layout):
    """Every tile edge: one row, a partial first tile, whole tiles, one row
    past a tile, and the training lengths 257 and 1025."""
    from maskbit_tpu_torch.nn import dropout_attention as da

    _card()
    b, h = 2, 3
    q, k, v = _qkv(b, n, h, seed=n, layout=layout)
    seeds = _seeds(b, h, seed=n + 2)
    gout = torch.randn(b, n, h, 64, generator=torch.Generator(device="cuda").manual_seed(n + 3),
                       device="cuda").bfloat16()
    out, grads = _launch_both(da, q, k, v, seeds, rate, gout)
    torch.cuda.synchronize()
    _check_against_plain(da, q, k, v, seeds, rate, out, grads, gout)


@pytest.mark.parametrize("n", [65, 257, 1025])
def test_dropout_attention_backward_is_deterministic(n):
    """Two calls on the same inputs give bit-identical dq, dk and dv: dq's
    sum over key tiles runs in a fixed order."""
    from maskbit_tpu_torch.nn import dropout_attention as da

    _card()
    b, h = 8, 16
    q, k, v = _qkv(b, n, h, seed=n, layout="packed")
    seeds = _seeds(b, h, seed=1)
    seeds32 = da.seeds_as_int32(seeds, (b, h))
    gout = torch.randn(b, n, h, 64, generator=torch.Generator(device="cuda").manual_seed(2),
                       device="cuda").bfloat16()
    out, lse = da.launch_forward(q, k, v, seeds32, 0.1)
    first = da.launch_backward(q, k, v, out, lse, gout, seeds32, 0.1)
    for _ in range(3):
        again = da.launch_backward(q, k, v, out, lse, gout, seeds32, 0.1)
        torch.cuda.synchronize()
        for x, y in zip(first, again):
            assert torch.equal(x, y)


@pytest.mark.parametrize("n", [17, 257, 1025])
def test_dropout_attention_backward_in_key_tile_order(n, monkeypatch):
    """The backward's second design, which sums dq in key-tile order (the
    wrapper takes it past ROTATE_MAX_TILES tiles), against the plain
    version, and deterministic too."""
    from maskbit_tpu_torch.nn import dropout_attention as da

    _card()
    monkeypatch.setattr(da, "ROTATE_MAX_TILES", 0)
    b, h, rate = 2, 4, 0.1
    q, k, v = _qkv(b, n, h, seed=n + 5, layout="packed")
    seeds = _seeds(b, h, seed=3)
    gout = torch.randn(b, n, h, 64, generator=torch.Generator(device="cuda").manual_seed(4),
                       device="cuda").bfloat16()
    out, grads = _launch_both(da, q, k, v, seeds, rate, gout)
    _, again = _launch_both(da, q, k, v, seeds, rate, gout)
    torch.cuda.synchronize()
    _check_against_plain(da, q, k, v, seeds, rate, out, grads, gout)
    for x, y in zip(grads, again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("b,n,h", [(2, 200, 2), (2, 65, 3), (1, 257, 4)])
def test_dropout_attention_kernel_mask_is_the_hash_mask(b, n, h):
    """The forward kernel's keep mask, read out at zero logits with one-hot
    values (`chip_smoke.kernel_keep_mask`), equals the plain version's bit
    for bit."""
    _card()
    import chip_smoke
    from maskbit_tpu_torch.nn import dropout_attention as da

    seeds = _seeds(b, h, seed=4)
    got = chip_smoke.kernel_keep_mask(torch, da, seeds, b, n, h)
    assert torch.equal(got, da.hash_keep_mask(seeds, n, chip_smoke.RATE))


@pytest.mark.parametrize("n", [17, 257])
def test_fused_attention_kernel_matches_plain_version(n):
    from maskbit_tpu_torch.nn import dropout_attention as da

    _card()
    q, k, v = _qkv(2, n, 4, seed=11, layout="packed")
    before = da.launches["fused_attention"]
    got = da.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert da.launches["fused_attention"] == before + 1
    want = da.fused_attention_reference(q.float(), k.float(), v.float())
    assert (got.float() - want).abs().max().item() <= DROPOUT_ATOL


def test_dropout_attention_kernel_rejects_bad_inputs():
    from maskbit_tpu_torch.nn import dropout_attention as da

    _card()
    q, k, v = _qkv(1, 17, 2, seed=0)
    s = _seeds(1, 2, seed=1)
    with pytest.raises(TypeError):
        da.dropout_attention(q.float(), k.float(), v.float(), s, 0.1)
    with pytest.raises(ValueError, match="head dim"):
        da.dropout_attention(q[..., :32], k[..., :32], v[..., :32], s, 0.1)
    with pytest.raises(ValueError, match="strides"):
        da.dropout_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, s, 0.1)


def _train_state_on_card(remat, seed=0):
    """A bf16 LFQBert (depth 2, hidden 128, 2 heads of 64, seq 257) with
    hidden dropout 0.1 and attention dropout 0.1 through the kernels."""
    from maskbit_tpu_torch.cli.common import build_module
    from maskbit_tpu_torch.models.generator import LFQBert, init_generator_weights_
    from maskbit_tpu_torch.train.generator_trainer import init_generator_train_state
    from maskbit_tpu_torch.train.optim import make_optimizer

    model = build_module(lambda: LFQBert(
        img_size=256, hidden_dim=128, codebook_size=2**14, codebook_splits=2, depth=2, heads=2,
        mlp_dim=256, dropout=0.1, attention_dropout=0.1, fused_attention_dropout=True,
        remat=remat, dtype=torch.bfloat16), "cuda")
    init_generator_weights_(model, torch.Generator(device="cuda").manual_seed(seed))
    opt = make_optimizer(model.parameters(), lambda t: 1e-3, beta2=0.96)
    return init_generator_train_state(model, opt)


def _steps_on_card(state, n, seed=3):
    from maskbit_tpu_torch.losses.mlm import MLMLossConfig
    from maskbit_tpu_torch.train.generator_trainer import make_generator_train_step_from_tokens

    step = make_generator_train_step_from_tokens(state.model, 2**14, MLMLossConfig(),
                                                 log_param_grad_norms=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    metrics = []
    for _ in range(n):
        tokens = torch.randint(0, 2**14, (4, 256), generator=g, device="cuda")
        labels = torch.randint(0, 1000, (4,), generator=g, device="cuda")
        state, m = step(state, tokens, labels, gen)
        metrics.append({k: v.clone() for k, v in m.items() if not k.startswith("_")})
    torch.cuda.synchronize()
    return metrics, gen.get_state()


def test_remat_on_the_card_matches_remat_off_with_the_dropout_kernels():
    """Remat on and off, one generator seed, two steps: the same losses and
    per-parameter gradient norms and the same parameters, bit for bit (the
    kernels and cuBLAS are deterministic for fixed shapes); the recompute
    launches the dropout forward kernel once more per layer and step."""
    from maskbit_tpu_torch.nn import dropout_attention as da

    _card()
    results = {}
    for remat in (False, True):
        state = _train_state_on_card(remat)
        before = dict(da.launches)
        metrics, gen_state = _steps_on_card(state, 2)
        launched = {k: da.launches[k] - before[k] for k in before}
        params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        results[remat] = (metrics, gen_state, launched, params)
    (m0, g0, l0, p0), (m1, g1, l1, p1) = results[False], results[True]
    assert l0["dropout_attention_fwd"] == 2 * 2 and l0["dropout_attention_bwd"] == 2 * 2
    assert l1["dropout_attention_fwd"] == 2 * 2 * 2 and l1["dropout_attention_bwd"] == 2 * 2
    assert torch.equal(g0, g1)
    for a, b in zip(m0, m1):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n


def test_checkpoint_round_trip_of_a_card_train_state(tmp_path):
    """A train state on the card, saved and restored into a fresh one, equal
    bit for bit and still on the card; the next steps agree bit for bit."""
    from maskbit_tpu_torch.core.checkpoint import CheckpointManager

    _card()
    saved = _train_state_on_card(False)
    _steps_on_card(saved, 2)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1)
    mgr.save(2, saved)
    mgr.close()
    fresh = _train_state_on_card(False, seed=1)
    _, step = CheckpointManager(str(tmp_path)).restore_latest(fresh)
    assert step == 2 and fresh.step == 2 and fresh.opt.count == 2 and fresh.ema.step == 2
    a, b = saved.state_dict(), fresh.state_dict()
    pairs = list(zip(a["params"].values(), b["params"].values()))
    pairs += list(zip(a["opt"]["mu"] + a["opt"]["nu"], b["opt"]["mu"] + b["opt"]["nu"]))
    pairs += list(zip(a["ema"]["params"].values(), b["ema"]["params"].values()))
    for x, y in pairs:
        assert y.is_cuda and torch.equal(x, y)
    m_saved, _ = _steps_on_card(saved, 1, seed=9)
    m_fresh, _ = _steps_on_card(fresh, 1, seed=9)
    assert torch.equal(m_saved[0]["mlm_loss"], m_fresh[0]["mlm_loss"])


def test_resize_bilinear_tf1_on_the_card_is_bit_exact():
    """The TF1 resize on the card equals its run on the CPU bit for bit
    (three separate eager ops, no FMA), 256 -> 299 and a downsample."""
    _card()
    from maskbit_tpu_torch.eval.inception import resize_bilinear_tf1

    for in_hw in ((256, 256), (512, 384)):
        x = torch.from_numpy(np.random.default_rng(in_hw[1]).uniform(
            0, 255, (4, *in_hw, 3)).astype(np.float32))
        assert torch.equal(resize_bilinear_tf1(x.cuda(), 299, 299).cpu(),
                           resize_bilinear_tf1(x, 299, 299))


def test_inception_on_the_card_holds_tf32_off():
    """float32 Inception features on the card against the CPU's, with the
    global TF32 flags on: the module holds TF32 off in its own forward (a
    TF32 convolution stack drifts by about 1e-3 relative) and gives the
    caller's flags back."""
    _card()
    from maskbit_tpu_torch.eval.inception import inception_from_state, random_inception_state

    state = random_inception_state(5)
    images = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 256, 256, 3),
                                                                dtype=np.uint8))
    card, cpu = inception_from_state(state, "cuda"), inception_from_state(state, "cpu")
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        with torch.inference_mode():
            got = card(images.cuda())
            want = cpu(images)
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
    for key in ("2048", "logits_unbiased"):
        scale = want[key].abs().max().item()
        assert (got[key].cpu() - want[key]).abs().max().item() <= 1e-4 * scale, key


def test_vq_indices_on_the_card_equal_the_cpus():
    """The nearest-code search in full float32 (TF32 off) on the card picks
    the CPU's codes, at the 12-bit VQ tokenizer's codebook (4096 x 12)."""
    _card()
    from maskbit_tpu_torch.quantizers.vq import SimpleVectorizer

    q = SimpleVectorizer(4096, 12).eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        q.embedding.weight.normal_(generator=gen)
    z = torch.randn(8, 16, 16, 12, generator=gen)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.inference_mode():
            got = q.cuda()(z.cuda())[1]["min_encoding_indices"].cpu()
            want = q.cpu()(z)[1]["min_encoding_indices"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(got, want)


def test_lfq_entropy_on_the_card_holds_tf32_off():
    """The streamed entropy (14 bits, chunks of 4096, T 0.01) on the card
    with both global TF32 flags on, against the CPU: the terms within rtol
    1e-4 and the gradient within 1e-3 of its largest entry."""
    from maskbit_tpu_torch.ops.entropy import lfq_entropy_terms

    _card()
    z = torch.from_numpy(
        (np.random.default_rng(0).normal(size=(4, 16, 16, 14)) * 0.05).astype(np.float32))

    def run(dev):
        zt = z.to(dev, copy=True).requires_grad_()
        terms = lfq_entropy_terms(zt, 14, 0.01, 1.0, 4096)
        (terms[0] - terms[1]).backward()
        return [float(t.detach()) for t in terms], zt.grad.cpu()

    want, want_grad = run("cpu")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        got, got_grad = run("cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert (got_grad - want_grad).abs().max() <= 1e-3 * want_grad.abs().max()


def test_stage1_step_on_the_card_matches_the_cpus():
    """One float32 Stage-I step of a 32 px tokenizer with the discriminator
    and adaptive weight live (TF32 off) on the card and on the CPU from the
    same weights: every loss and metric within rtol 1e-3."""
    from maskbit_tpu_torch.losses.vqgan import VQGANLossConfig
    from maskbit_tpu_torch.models.tokenizer import ConvVQModel, init_tokenizer_weights_
    from maskbit_tpu_torch.nn.discriminator import (
        NLayerDiscriminatorv2,
        init_discriminator_weights_,
    )
    from maskbit_tpu_torch.train.optim import make_optimizer
    from maskbit_tpu_torch.train.tokenizer_trainer import (
        init_tokenizer_train_state,
        make_tokenizer_train_step,
    )

    _card()
    torch.backends.cudnn.allow_tf32 = False
    loss_cfg = VQGANLossConfig(perceptual_weight=0.0, discriminator_gradient_penalty="adopt_weight",
                               lecam_regularization_weight=0.001, discriminator_weight=0.1)
    images = torch.from_numpy(
        np.random.default_rng(1).uniform(size=(2, 32, 32, 3)).astype(np.float32))
    model = ConvVQModel(hidden_channels=64, channel_mult=(1, 2), num_resolutions=2,
                        num_res_blocks=1, token_size=10, codebook_size=1024,
                        entropy_loss_weight=0.02)
    disc = NLayerDiscriminatorv2(hidden_channels=64, num_stages=1, blur_resample=True)
    init_tokenizer_weights_(model, torch.Generator().manual_seed(0))
    init_discriminator_weights_(disc, torch.Generator().manual_seed(1))
    start = ({k: v.clone() for k, v in model.state_dict().items()},
             {k: v.clone() for k, v in disc.state_dict().items()})
    metrics = {}
    for dev in ("cpu", "cuda"):
        model.load_state_dict(start[0])
        disc.load_state_dict(start[1])
        model.to(dev), disc.to(dev)
        state = init_tokenizer_train_state(model, disc,
                                           make_optimizer(model.parameters(), lambda t: 1e-4),
                                           make_optimizer(disc.parameters(), lambda t: 1e-4))
        step = make_tokenizer_train_step(model, disc, loss_cfg, ema_kwargs={"decay": 0.999})
        metrics[dev] = {k: float(v) for k, v in step(state, images.to(dev))[1].items()}
    for key, want in metrics["cpu"].items():
        np.testing.assert_allclose(metrics["cuda"][key], want, rtol=1e-3, atol=1e-6, err_msg=key)
