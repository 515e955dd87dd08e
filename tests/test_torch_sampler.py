"""Port parity: the masked CFG sampler, and the slice as a whole.

Randomness is drawn once with numpy and injected into both samplers
(`injected=(token_draws, gumbel_draws)`), so tokens must agree exactly.
The end-to-end test runs the port's `make_sampler` (LFQBert with the fused
attention block, combine, LFQ unpack, ConvDecoder) against the JAX chain
`sample_tokens` -> `combine_factorized_tokens` -> `decode_tokens` with the
same exported weights: tokens exact, images within atol 1e-4 (float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskbit_tpu.models.generator import LFQBert as JaxLFQBert
from maskbit_tpu.models.tokenizer import ConvVQModel as JaxConvVQModel
from maskbit_tpu.ops.bitops import combine_factorized_tokens as jax_combine
from maskbit_tpu.sampling import sample as jsample
from maskbit_tpu_torch.compat.weights import generator_from_flax, tokenizer_from_flax
from maskbit_tpu_torch.models.generator import LFQBert
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from maskbit_tpu_torch.sampling import sample as tsample
from tests.test_cli_eval_demo import TINY_MLM, TINY_VQ

torch.set_num_threads(2)

B, N, M, C = 3, 16, 2, 8  # batch, positions, splits, effective codebook


def _cfg(module, **kw):
    base = dict(softmax_temperature=1.0, randomize_temperature=4.5,
                mask_schedule_strategy="arccos", num_steps=6, guidance_scale=3.0,
                mask_token=C, patch_size=4, guidance_annealing="cosine",
                use_sampling_annealing=False, scale_pow=3.0, codebook_size=C * C,
                codebook_splits=M)
    base.update(kw)
    return module.SamplingConfig(**base)


CONFIGS = {
    "cosine": {},
    "linear_annealed": dict(guidance_annealing="linear", use_sampling_annealing=True,
                            mask_schedule_strategy="cosine"),
    "no_cfg": dict(guidance_scale=0.0, mask_schedule_strategy="linear",
                   softmax_temperature=0.7),
    "none_root": dict(guidance_annealing="none", mask_schedule_strategy="root", num_steps=4),
}


@pytest.mark.parametrize("step", [0, 2, 5])
@pytest.mark.parametrize("name", ["cosine", "linear_annealed"])
def test_confidence_remask_exact(name, step):
    rng = np.random.default_rng(step)
    masked = rng.integers(0, C + 1, size=(B, N, M)).astype(np.int32)
    masked[0, :3] = C  # batch element 0 sets the count; keep it masked-heavy
    sampled = rng.integers(0, C, size=(B, N, M)).astype(np.int32)
    probs = rng.dirichlet(np.ones(C), size=(B, N, M)).astype(np.float32)
    gumbel = rng.gumbel(size=(B, N, M)).astype(np.float32)
    mask = masked == C
    jp, jm = jsample.confidence_remask(_cfg(jsample, **CONFIGS[name]), jnp.int32(step),
                                       *map(jnp.asarray, (mask, masked, sampled, probs, gumbel)))
    tp, tm = tsample.confidence_remask(_cfg(tsample, **CONFIGS[name]), step,
                                       *map(torch.from_numpy, (mask, masked, sampled, probs,
                                                               gumbel)))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_confidence_remask_single_masked_token_wraps():
    """num_masked == 1 makes the count 0; the threshold index -1 wraps to
    the largest confidence, as jnp.take does."""
    masked = np.zeros((1, N, M), np.int32)
    masked[0, 0, 0] = C
    sampled = np.ones_like(masked)
    probs = np.full((1, N, M, C), 1.0 / C, np.float32)
    gumbel = np.zeros((1, N, M), np.float32)
    args = (masked == C, masked, sampled, probs, gumbel)
    jp, jm = jsample.confidence_remask(_cfg(jsample), jnp.int32(1), *map(jnp.asarray, args))
    tp, tm = tsample.confidence_remask(_cfg(tsample), 1, *map(torch.from_numpy, args))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sample_tokens_injected_exact(name):
    jcfg, tcfg = _cfg(jsample, **CONFIGS[name]), _cfg(tsample, **CONFIGS[name])
    steps = jcfg.num_steps
    rng = np.random.default_rng(len(name))
    # logits = per-row base + a table over the current token, so that they
    # change as tokens unmask and a wrong re-mask shows up downstream
    base = (rng.normal(size=(2 * B, N, M, C)) * 3).astype(np.float32)
    table = rng.normal(size=(C + 1, C)).astype(np.float32)
    token_draws = rng.integers(0, C, size=(steps, B, N, M)).astype(np.int32)
    gumbel_draws = rng.gumbel(size=(steps, B, N, M)).astype(np.float32)
    labels = np.arange(B, dtype=np.int32)

    def jax_fn(tokens, lbls, drop):
        return jnp.asarray(base)[: tokens.shape[0]] + jnp.asarray(table)[tokens]

    def torch_fn(tokens, lbls, drop):
        return torch.from_numpy(base)[: tokens.shape[0]] + torch.from_numpy(table)[tokens.long()]

    want, _ = jsample.sample_tokens(jax_fn, jax.random.key(0), jnp.asarray(labels), jcfg,
                                    injected=(token_draws, gumbel_draws))
    got = tsample.sample_tokens(torch_fn, torch.from_numpy(labels), tcfg,
                                injected=(torch.from_numpy(token_draws),
                                          torch.from_numpy(gumbel_draws)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_guidance_scale_schedule_matches():
    for ann in ("none", "linear", "cosine"):
        jcfg = _cfg(jsample, guidance_annealing=ann, num_steps=64)
        tcfg = _cfg(tsample, guidance_annealing=ann, num_steps=64)
        for step in range(64):
            np.testing.assert_allclose(
                tsample._guidance_scale_at(tcfg, step).item(),
                float(jsample._guidance_scale_at(jcfg, jnp.int32(step))),
                # float32 cos differs by an ulp between XLA and torch, and
                # 1 - cos cancels near 0: 1e-6 absolute on a scale of 3
                rtol=3e-7, atol=1e-6)


def test_sampler_draws_from_generator():
    """Without injected draws, the same torch.Generator seed gives the same
    tokens and another seed other tokens."""
    cfg = _cfg(tsample)
    logits = torch.from_numpy(np.random.default_rng(0).normal(size=(2 * B, N, M, C))
                              .astype(np.float32))
    fn = lambda tokens, lbls, drop: logits  # noqa: E731
    labels = torch.arange(B)
    run = lambda seed: tsample.sample_tokens(  # noqa: E731
        fn, labels, cfg, torch.Generator().manual_seed(seed))
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.max()) < C  # no mask token left in the result


def test_sampler_refuses_global_rng():
    """Neither a generator nor injected draws: an error, not torch's
    global random stream."""
    with pytest.raises(ValueError, match="Generator"):
        tsample.sample_tokens(lambda *a: None, torch.arange(B), _cfg(tsample))


def test_default_labels_cycle():
    labels = tsample.default_labels(15, torch.Generator().manual_seed(0))
    assert labels.tolist()[:9] == list(tsample.DEFAULT_LABELS) and len(labels) == 10


def test_slice_make_sampler_matches_jax_chain():
    mlm = dict(TINY_MLM, attention_impl="fused", num_steps=4)
    jgen = JaxLFQBert.from_config(mlm, TINY_VQ)
    jtok = JaxConvVQModel.from_config(TINY_VQ)
    gen_vars = jgen.init(jax.random.key(0), jnp.zeros((1, jgen.seq_len, 2), jnp.int32),
                         jnp.zeros((1,), jnp.int32))
    tok_vars = jtok.init(jax.random.key(1), jnp.zeros((1, 32, 32, 3)))
    tgen = generator_from_flax(jax.tree.map(np.asarray, gen_vars),
                               LFQBert.from_config(mlm, TINY_VQ).eval())
    ttok = tokenizer_from_flax(jax.tree.map(np.asarray, tok_vars),
                               ConvVQModel.from_config(TINY_VQ).eval(), TINY_VQ["codebook_size"])

    jcfg = jsample.SamplingConfig.from_config(mlm, TINY_VQ)
    tcfg = tsample.SamplingConfig.from_config(mlm, TINY_VQ)
    assert tuple(tcfg) == tuple(jcfg)
    rng = np.random.default_rng(7)
    b, steps, n = 2, jcfg.num_steps, jcfg.patch_size**2
    token_draws = rng.integers(0, jcfg.mask_token, size=(steps, b, n, 2)).astype(np.int32)
    gumbel_draws = rng.gumbel(size=(steps, b, n, 2)).astype(np.float32)
    labels = np.asarray([3, 9], np.int32)

    def logits_fn(tokens, lbls, drop):
        return jgen.apply(gen_vars, tokens, lbls, drop, deterministic=True)

    jtokens, _ = jsample.sample_tokens(logits_fn, jax.random.key(0), jnp.asarray(labels), jcfg,
                                       injected=(token_draws, gumbel_draws))
    jcombined = jax_combine(jtokens, jcfg.codebook_size, jcfg.codebook_splits)
    jimages = jtok.apply(tok_vars, jcombined, method="decode_tokens")

    sampler = tsample.make_sampler(tgen, ttok, tcfg)
    images, tokens = sampler(torch.from_numpy(labels),
                             injected=(torch.from_numpy(token_draws),
                                       torch.from_numpy(gumbel_draws)))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jcombined))
    assert images.shape == (b, 32, 32, 3)
    np.testing.assert_allclose(images.numpy(), np.asarray(jimages), atol=1e-4, rtol=0)
