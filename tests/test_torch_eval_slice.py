"""The evaluation slice as a whole, port against JAX: injected tokens ->
`decode_tokens` -> the uint8 truncation -> InceptionV3 -> the ADM
accumulator -> IS and FID.

The same weights on both sides (the JAX tokenizer's carried across with
`tokenizer_from_flax`; seeded random pt-fid Inception weights, read by the
JAX package through its own `convert_inception_state`), float32, a tiny
tokenizer, 8 samples. The tolerances come from the gaps measured here: the
features' largest difference `gap` (relative to their largest value) and
the logits' largest absolute difference. FID is a polynomial of degree two
in the features (with a matrix square root), so it moves by at most a few
`gap` times the size of its terms: |dFID| <= 10 gap (FID + tr S_real +
tr S_fake). The log of IS moves by at most twice the largest logit
change: |d log IS| <= 2 dlogit (each log-softmax moves by at most that).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from maskbit_tpu.eval.adm import AdmMomentAccumulator as JaxAccumulator
from maskbit_tpu.eval.adm import FIDStatistics as JaxFIDStatistics
from maskbit_tpu.eval.inception import InceptionV3 as JaxInceptionV3
from maskbit_tpu.eval.inception import convert_inception_state
from maskbit_tpu.models.tokenizer import ConvVQModel as JaxConvVQModel
from maskbit_tpu_torch.cli.eval_maskbit import to_pixels_255
from maskbit_tpu_torch.compat.weights import tokenizer_from_flax
from maskbit_tpu_torch.eval.adm import AdmMomentAccumulator, FIDStatistics
from maskbit_tpu_torch.eval.inception import inception_from_state, random_inception_state
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from tests.test_cli_eval_demo import TINY_VQ

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS thread: the 2048-wide `sqrtm` of an FID is mostly serial,
    and more threads only take cores from the tests running beside it."""
    with threadpool_limits(1):
        yield


def test_tokens_to_fid_matches_jax():
    n = 8
    jtok = JaxConvVQModel.from_config(TINY_VQ)
    tok_vars = jax.jit(jtok.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    tok = ConvVQModel.from_config(TINY_VQ).eval()
    tokenizer_from_flax(jax.tree.map(np.asarray, tok_vars), tok, TINY_VQ["codebook_size"])
    state = random_inception_state(4)
    inc_vars = convert_inception_state({k: v.numpy() for k, v in state.items()})
    inception = inception_from_state(state, "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, TINY_VQ["codebook_size"], size=(n, 256)).astype(np.int32)
    ref = rng.normal(size=(32, 2048)) * 0.05
    real = (ref.mean(0), np.cov(ref, rowvar=False))

    images = jtok.apply(tok_vars, jnp.asarray(tokens), method="decode_tokens")
    jpix = jnp.floor(jnp.clip(images, 0.0, 1.0) * 255.0)
    jfeats = JaxInceptionV3().apply(inc_vars, jpix)
    jacc = JaxAccumulator(total_samples=n)
    jacc.update(np.asarray(jfeats["2048"]), np.asarray(jfeats["logits_unbiased"]), np.arange(n))
    want_is = jacc.inception_score()
    want_fid = jacc.fid_statistics().frechet_distance(JaxFIDStatistics(*real))

    with torch.inference_mode():
        pix = to_pixels_255(tok.decode_tokens(torch.from_numpy(tokens)))
        feats = inception(pix)
    acc = AdmMomentAccumulator(total_samples=n)
    acc.update(feats["2048"], feats["logits_unbiased"], np.arange(n))
    got_is = acc.inception_score()
    stats = acc.fid_statistics()
    got_fid = stats.frechet_distance(FIDStatistics(*real))

    pixel_flips = int((pix.numpy() != np.asarray(jpix)).sum())
    assert pixel_flips <= 0.01 * pix.numel()  # truncation ties only
    f_t, f_j = feats["2048"].numpy(), np.asarray(jfeats["2048"])
    gap = np.abs(f_t - f_j).max() / np.abs(f_j).max()
    dlogit = np.abs(feats["logits_unbiased"].numpy() - np.asarray(jfeats["logits_unbiased"])).max()
    assert gap < 1e-4 and np.isfinite([got_fid, got_is]).all()
    terms = got_fid + np.trace(real[1]) + np.trace(stats.sigma)
    assert abs(got_fid - want_fid) <= 10 * gap * terms, (got_fid, want_fid, gap)
    assert abs(np.log(got_is) - np.log(want_is)) <= 2 * dlogit, (got_is, want_is, dlogit)
    print(f"pixel flips {pixel_flips}, feature gap {gap:.2e}, logit gap {dlogit:.2e}, "
          f"FID {got_fid} vs {want_fid}, IS {got_is} vs {want_is}")
