"""Port parity: FID math, the ADM accumulator and the streaming evaluators.

* `eval/fid.py` and `eval/adm.py` against the JAX package's on the same
  float64 inputs, to 1e-10 relative: covariance, Frechet distance, FID and
  IS from moments, the `.npz` statistics, and `AdmMomentAccumulator`
  against a full gather (three partial accumulators over strided samples,
  IS splits that cut batches, merged through `merge_state`).
* `eval/streaming.py`: `TokenizerEvaluator` with all 9 metrics and
  `GeneratorEvaluator`, on the same image pairs and codebook indices over
  two updates, against the JAX evaluators to 1e-5 relative; codebook usage
  and entropy exactly. Both sides get the same Inception and LPIPS
  stand-ins (float64 numpy functions of the pixels they are handed), so
  the comparison covers what the evaluators compute: the pixel sums, the
  SSIM convolution, the uint8 truncation, the softmax moments and the
  float64 host math.
* The cross-process merges run under an initialised one-process
  `torch.distributed` group and leave the accumulators as they were (the
  merges across processes: `tests/test_torch_distributed.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from maskbit_tpu.eval import adm as jax_adm
from maskbit_tpu.eval import fid as jax_fid
from maskbit_tpu.eval import streaming as jax_streaming
from maskbit_tpu_torch.eval import adm, fid, streaming

torch.set_num_threads(2)
RTOL64 = 1e-10


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS thread: the 2048-wide `sqrtm` of an FID is mostly serial,
    and more threads only take cores from the tests running beside it."""
    with threadpool_limits(1):
        yield


def test_fid_math_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(300, 16)), rng.normal(size=(300, 16)) * 1.3 + 0.2
    np.testing.assert_allclose(fid.get_covariance(a.T @ a, a.sum(0), 300),
                               jax_fid.get_covariance(a.T @ a, a.sum(0), 300), rtol=RTOL64)
    args = (a.sum(0), a.T @ a, b.sum(0), b.T @ b, 300)
    np.testing.assert_allclose(fid.fid_from_moments(*args), jax_fid.fid_from_moments(*args),
                               rtol=RTOL64)
    np.testing.assert_allclose(
        fid.frechet_distance(a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False)),
        jax_fid.frechet_distance(a.mean(0), np.cov(a, rowvar=False), b.mean(0),
                                 np.cov(b, rowvar=False)), rtol=RTOL64)
    probs = rng.dirichlet(np.ones(1008), size=50)
    args = (probs.sum(0), (probs * np.log(probs + 1e-16)).sum(0), 50)
    np.testing.assert_allclose(fid.inception_score_from_moments(*args),
                               jax_fid.inception_score_from_moments(*args), rtol=RTOL64)
    fid.save_stats_npz(str(tmp_path / "s.npz"), a.mean(0), np.cov(a, rowvar=False))
    for got, want in zip(fid.load_stats_npz(str(tmp_path / "s.npz")),
                         jax_fid.load_stats_npz(str(tmp_path / "s.npz"))):
        np.testing.assert_array_equal(got, want)


def test_adm_accumulator_matches_full_gather_and_jax():
    rng = np.random.default_rng(1)
    n, dim, nclass, split = 130, 8, 6, 50
    acts = rng.normal(size=(n, dim))
    logits = rng.normal(size=(n, nclass)) * 3.0
    ev = adm.Evaluator(inception_fn=None)
    ref_stats = ev.compute_statistics(acts)
    ref_is = ev.compute_inception_score_from_logits(logits, split_size=split)
    np.testing.assert_allclose(ref_is, jax_adm.Evaluator(None).compute_inception_score_from_logits(
        logits, split_size=split), rtol=RTOL64)

    def accumulate(module):
        hosts = []
        for p in range(3):  # strided samples, batches of 16 that cut the splits
            acc = module.AdmMomentAccumulator(dim=dim, nclass=nclass, total_samples=n,
                                              split_size=split)
            idx = np.arange(n)[p::3]
            for lo in range(0, len(idx), 16):
                sel = idx[lo:lo + 16]
                acc.update(acts[sel], logits[sel], sel)
            hosts.append(acc)
        for other in hosts[1:]:
            hosts[0].merge_state(other.state())
        return hosts[0]

    merged, jax_merged = accumulate(adm), accumulate(jax_adm)
    assert merged.count == n and merged.split_count.tolist() == [50, 50, 30]
    stats = merged.fid_statistics()
    np.testing.assert_allclose(stats.mu, ref_stats.mu, rtol=1e-12)
    np.testing.assert_allclose(stats.sigma, ref_stats.sigma, rtol=1e-9)
    np.testing.assert_allclose(merged.inception_score(), ref_is, rtol=1e-12)
    for name in merged._ARRAYS:
        np.testing.assert_allclose(getattr(merged, name), getattr(jax_merged, name), rtol=RTOL64)
    np.testing.assert_allclose(merged.inception_score(), jax_merged.inception_score(),
                               rtol=RTOL64)
    shifted = ev.compute_statistics(acts + 0.5)
    np.testing.assert_allclose(stats.frechet_distance(shifted),
                               jax_merged.fid_statistics().frechet_distance(
                                   jax_adm.FIDStatistics(shifted.mu, shifted.sigma)), rtol=RTOL64)
    # a torch tensor on the way in is the same as its numpy array
    acc = adm.AdmMomentAccumulator(dim=dim, nclass=nclass, total_samples=n, split_size=split)
    acc.update(torch.from_numpy(acts), torch.from_numpy(logits), np.arange(n))
    np.testing.assert_allclose(acc.act_outer, merged.act_outer, rtol=1e-12)


_PROJ = np.random.default_rng(5).normal(size=(12, 2048))


def _stub_features(u8) -> dict:
    """Stand-in for InceptionV3 on the pixels it is handed, in float64
    numpy: the per-quadrant channel means through a fixed projection."""
    x = np.asarray(u8, np.float64) / 255.0
    h, w = x.shape[1] // 2, x.shape[2] // 2
    pooled = np.concatenate([x[:, :h, :w].mean((1, 2)), x[:, :h, w:].mean((1, 2)),
                             x[:, h:, :w].mean((1, 2)), x[:, h:, w:].mean((1, 2))], axis=1)
    feats = pooled @ _PROJ
    return {"2048": feats.astype(np.float32), "logits_unbiased": (3 * feats[:, :1008]).astype(
        np.float32)}


def _port_inception(images):
    return {k: torch.from_numpy(v) for k, v in _stub_features(images.cpu().numpy()).items()}


def _port_lpips(real, fake):
    return torch.from_numpy(np.abs(real.numpy().astype(np.float64)
                                   - fake.numpy()).mean((1, 2, 3)))


def _jax_lpips(real, fake):
    return jnp.asarray(np.abs(np.asarray(real, np.float64) - np.asarray(fake)).mean((1, 2, 3)))


ALL = dict(enable_rfid=True, enable_inception_score=True, enable_psnr_score=True,
           enable_ssim_score=True, enable_lpips_score=True, enable_mse_error=True,
           enable_mae_error=True, enable_codebook_usage_measure=True,
           enable_codebook_entropy_measure=True, num_codebook_entries=64)


def test_tokenizer_evaluator_all_nine_metrics_match_jax():
    rng = np.random.default_rng(2)
    port = streaming.TokenizerEvaluator(_port_inception, _port_lpips, **ALL)
    ref = jax_streaming.TokenizerEvaluator(lambda u8: _stub_features(u8), _jax_lpips, **ALL)
    for _ in range(2):
        real = rng.uniform(size=(6, 32, 32, 3)).astype(np.float32)
        fake = np.clip(real + rng.normal(scale=0.1, size=real.shape), 0, 1).astype(np.float32)
        indices = rng.integers(0, 40, size=(6, 16, 16))
        port.update(torch.from_numpy(real), torch.from_numpy(fake),
                    codebook_indices=torch.from_numpy(indices))
        ref.update(jnp.asarray(real), jnp.asarray(fake), codebook_indices=jnp.asarray(indices))
    got, want = port.result(), ref.result()
    assert list(got) == list(want) and len(got) == 9
    for key in want:
        if key.startswith("Codebook"):
            assert got[key] == want[key], key
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)


def test_ssim_and_pixel_sums_against_numpy():
    """The SSIM convolution and pixel sums against an independent float64
    computation (the JAX package's formula)."""
    rng = np.random.default_rng(3)
    real = rng.uniform(size=(2, 24, 24, 3))
    fake = np.clip(real + rng.normal(scale=0.1, size=real.shape), 0, 1)
    k = streaming.gaussian_kernel_2d().astype(np.float64)

    def depthwise(x):
        x = np.pad(x, ((0, 0), (5, 5), (5, 5), (0, 0)), mode="reflect")
        out = np.zeros(real.shape)
        for i in range(11):
            for j in range(11):
                out += k[i, j] * x[:, i:i + 24, j:j + 24]
        return out

    mu_f, mu_r = depthwise(fake), depthwise(real)
    s_f, s_r = depthwise(fake**2) - mu_f**2, depthwise(real**2) - mu_r**2
    s_fr = depthwise(fake * real) - mu_f * mu_r
    c1, c2 = 0.01**2, 0.03**2
    want = (((2 * mu_f * mu_r + c1) * (2 * s_fr + c2))
            / ((mu_f**2 + mu_r**2 + c1) * (s_f + s_r + c2))).mean((1, 2, 3)).sum()
    t_real, t_fake = (torch.from_numpy(x.astype(np.float32)) for x in (real, fake))
    np.testing.assert_allclose(float(streaming._ssim_sum(t_real, t_fake)), want, rtol=1e-5)
    mse = ((fake - real) ** 2).mean((1, 2, 3))
    for got, ref in zip(streaming._pixel_sums(t_real, t_fake),
                        (np.abs(fake - real).mean((1, 2, 3)).sum(), mse.sum(),
                         (10 * np.log10(1 / (mse + 1e-10))).sum())):
        np.testing.assert_allclose(float(got), ref, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generator_evaluator_matches_jax(dtype):
    """Images in float32 and in bf16, where the uint8 truncation is computed
    in bf16 on both sides. The IS only: the FID's host math is that of
    `fid_from_moments` (above) and of eval_maskbit's parity test, and a
    2048-wide sqrtm costs about 20 CPU-seconds."""
    rng = np.random.default_rng(4)
    port = streaming.GeneratorEvaluator(_port_inception)
    ref = jax_streaming.GeneratorEvaluator(lambda u8: _stub_features(u8))
    for _ in range(2):
        fake = rng.uniform(-0.1, 1.1, size=(8, 32, 32, 3)).astype(np.float32)
        t = torch.from_numpy(fake).to(getattr(torch, dtype))
        port.update(t)
        ref.update(jnp.asarray(t.float().numpy(), getattr(jnp, dtype)))
    got, want = port.result(), ref.result()
    assert list(got) == ["InceptionScore"] == list(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)


def test_merges_refuse_to_run_across_processes(tmp_path):
    """Once refused under `torch.distributed`; now a merge in a one-process
    group runs and changes nothing."""
    import torch.distributed as dist

    acc = adm.AdmMomentAccumulator(dim=4, nclass=3, total_samples=10)
    rng = np.random.default_rng(3)
    acc.update(rng.normal(size=(5, 4)), rng.normal(size=(5, 3)), np.arange(5))
    evaluators = [acc, streaming.TokenizerEvaluator(), streaming.GeneratorEvaluator(None)]
    before = {k: np.array(v, copy=True) for k, v in acc.state().items()}
    for ev in evaluators:
        ev.merge_across_hosts()  # one process: nothing to merge
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)
    try:
        for ev in evaluators:
            ev.merge_across_hosts()
        for key, value in acc.state().items():
            np.testing.assert_array_equal(value, before[key], err_msg=key)
    finally:
        dist.destroy_process_group()
