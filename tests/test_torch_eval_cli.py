"""Port parity: `cli/eval_maskbit` and `cli/make_stats` against the JAX CLIs.

`eval_maskbit`, (total 250, batch 100), with each side's sampler replaced by
the same stand-in (each sample's image a seeded function of its label, in
the compute dtype) and the same Inception stand-in (float64 numpy of the
pixels it is handed); the JAX CLI runs on a one-device mesh, so both sides
cut the same batches:
  * the labels handed to the samplers are equal (class-balanced, numpy);
  * the last batch is padded to 100 and exactly 250 samples are scored;
  * the pixels reaching the Inception network are equal, at float32 and at
    bf16, where `floor(clip(x) * 255)` is computed in bf16 (and differs
    from the float32 product);
  * IS and FID (against an `.npz`) agree to 1e-6 relative.
The decoder of both packages gives bf16 images under bf16, so the stand-in's
dtype is the real one. `make_stats` over the same tar shard with the same
random pt-fid weights: `mu` and `sigma` agree within the features' float32
gap (rtol 1e-4).
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
from PIL import Image

import maskbit_tpu.cli.common as jax_common
import maskbit_tpu.cli.eval_maskbit as jax_em
from maskbit_tpu.models.tokenizer import ConvVQModel as JaxConvVQModel
from maskbit_tpu.parallel.mesh import MeshConfig, create_mesh
from maskbit_tpu_torch.cli import eval_maskbit as em
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from tests.test_cli_eval_demo import TINY_MLM, _cfg
from tests.test_torch_eval import _stub_features

torch.set_num_threads(2)
TOTAL, BATCH = 250, 100


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS thread: the 2048-wide `sqrtm` of an FID is mostly serial,
    and more threads only take cores from the tests running beside it."""
    with threadpool_limits(1):
        yield


def _images_for(labels) -> np.ndarray:
    """Each sample's image from its label alone, in [-0.05, 1.05]."""
    return np.stack([np.random.default_rng(int(y)).uniform(-0.05, 1.05, (32, 32, 3))
                     for y in np.asarray(labels)]).astype(np.float32)


def _run_both(tmp_path, monkeypatch, mixed_precision, stats_path=""):
    seen = {"jax": {"labels": [], "pixels": []}, "port": {"labels": [], "pixels": []}}
    jax_dtype = jnp.bfloat16 if mixed_precision == "bf16" else jnp.float32
    port_dtype = torch.bfloat16 if mixed_precision == "bf16" else torch.float32

    # the JAX CLI on a one-device mesh: batches of exactly eval.batch_size
    real_setup = jax_em.setup_experiment

    def one_device_setup(config, subdir=""):
        ctx = real_setup(config, subdir)
        ctx["mesh"] = create_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
        return ctx

    def jax_sampler(gv, tv, key, y):
        seen["jax"]["labels"].append(np.asarray(y))
        return jnp.asarray(_images_for(y), jax_dtype), None

    def jax_inception(images_255):
        seen["jax"]["pixels"].append(np.asarray(images_255, np.float32))
        return _stub_features(images_255)

    captured = {}
    real_acc = jax_em.AdmMomentAccumulator
    monkeypatch.setattr(jax_em, "AdmMomentAccumulator",
                        lambda *a, **k: captured.setdefault("acc", real_acc(*a, **k)))
    monkeypatch.setattr(jax_em, "setup_experiment", one_device_setup)
    monkeypatch.setattr(jax_common, "load_generation_models",
                        lambda config, logger: (None, None, None, None, None, 32, jax_dtype))
    monkeypatch.setattr(jax_em, "make_sampler", lambda *a, **k: jax_sampler)
    monkeypatch.setattr(jax_em, "make_inception_fn", lambda: jax_inception)

    def port_sampler(labels, rng):
        seen["port"]["labels"].append(labels.numpy())
        return torch.from_numpy(_images_for(labels)).to(port_dtype), None

    def port_inception(images_255):
        seen["port"]["pixels"].append(images_255.float().numpy())
        return {k: torch.from_numpy(v) for k, v in _stub_features(images_255.float()).items()}

    monkeypatch.setattr(em, "load_generation_models",
                        lambda config, logger, device: (None, None, None, 32, port_dtype))
    monkeypatch.setattr(em, "make_sampler", lambda *a, **k: port_sampler)
    monkeypatch.setattr(em, "make_inception_fn", lambda device: port_inception)

    monkeypatch.setenv("WORKSPACE", str(tmp_path / "ws"))
    extra = {"model.mlm_model": TINY_MLM, "eval.total_samples": TOTAL, "eval.batch_size": BATCH,
             "eval.stats_path": stats_path, "eval.device": "cpu",
             "training.mixed_precision": mixed_precision, "experiment.generator_checkpoint": ""}
    want = jax_em.main([f"config={_cfg(tmp_path, 'jax_gen', extra)}"])
    got = em.main([f"config={_cfg(tmp_path, 'port_gen', extra)}"])
    assert captured["acc"].count == TOTAL
    return got, want, seen


@pytest.mark.parametrize("mixed_precision", ["no", "bf16"])
def test_eval_maskbit_matches_jax(tmp_path, monkeypatch, mixed_precision):
    stats_path = ""
    if mixed_precision == "no":  # FID at float32 only: a 2048-wide sqrtm takes seconds
        ref = np.random.default_rng(1).normal(size=(64, 2048))
        stats_path = str(tmp_path / "ref_stats.npz")
        np.savez(stats_path, mu=ref.mean(0), sigma=np.cov(ref, rowvar=False))
    got, want, seen = _run_both(tmp_path, monkeypatch, mixed_precision, stats_path)

    labels = np.random.default_rng(0).permutation(1000)[:TOTAL]
    for side in ("jax", "port"):
        batches = seen[side]["labels"]
        assert [len(b) for b in batches] == [100, 100, 100]
        np.testing.assert_array_equal(np.concatenate(batches)[:TOTAL], labels)
        assert not np.concatenate(batches)[TOTAL:].any()  # pad rows sample class 0
    for a, b in zip(seen["port"]["pixels"], seen["jax"]["pixels"], strict=True):
        np.testing.assert_array_equal(a, b)
        assert a.min() >= 0 and a.max() <= 255 and np.array_equal(a, np.floor(a))
    if mixed_precision == "bf16":  # the product in bf16 floors into other bins than in f32
        f32 = np.floor(np.clip(_images_for(seen["port"]["labels"][0]).astype(np.float32),
                               0, 1) * 255)
        assert (f32 != seen["port"]["pixels"][0]).any()

    assert got["count"] == TOTAL and len(got["batch_seconds"]) == 3
    assert list(got["results"]) == list(want)
    assert list(want) == (["InceptionScore", "FID"] if stats_path else ["InceptionScore"])
    for key in want:
        np.testing.assert_allclose(got["results"][key], want[key], rtol=1e-6, err_msg=key)
    saved = json.load(open(f"{got['output_dir']}/eval_results.json"))
    assert saved == got["results"]


def test_decoders_give_images_in_the_compute_dtype():
    """Under bf16 both packages' decoders return bf16 images: the dtype in
    which eval_maskbit truncates to uint8."""
    from tests.test_cli_eval_demo import TINY_VQ

    tokens = np.random.default_rng(0).integers(0, 16, size=(1, 256)).astype(np.int32)
    jmodel = JaxConvVQModel.from_config(TINY_VQ, dtype=jnp.bfloat16)
    variables = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    out = jax.eval_shape(lambda v, t: jmodel.apply(v, t, method="decode_tokens"), variables,
                         jnp.asarray(tokens))
    assert out.dtype == jnp.bfloat16
    port = ConvVQModel.from_config(TINY_VQ, dtype=torch.bfloat16).eval()
    with torch.inference_mode():
        assert port.decode_tokens(torch.from_numpy(tokens)).dtype == torch.bfloat16


def test_make_stats_matches_jax(tmp_path, monkeypatch):
    from maskbit_tpu.cli.make_stats import main as jax_make_stats
    from maskbit_tpu_torch.cli.make_stats import main as make_stats
    from maskbit_tpu_torch.data.shard_writer import ShardWriter
    from maskbit_tpu_torch.eval.inception import random_inception_state

    rng = np.random.default_rng(0)
    writer = ShardWriter(str(tmp_path / "img-%04d.tar"))
    for i in range(5):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)).save(buf, "JPEG")
        writer.write(f"{i:06d}", buf.getvalue(), i)
    writer.close()
    torch.save(random_inception_state(1), tmp_path / "pt_inception.pth")
    monkeypatch.setenv("MASKBIT_INCEPTION_WEIGHTS", str(tmp_path / "pt_inception.pth"))
    monkeypatch.delenv("MASKBIT_ADM_PB", raising=False)
    args = ["--shards", str(tmp_path / "img-0000.tar"), "--resolution", "32", "--batch_size", "2"]
    jax_make_stats(args + ["--output", str(tmp_path / "jax.npz")])
    assert make_stats(args + ["--output", str(tmp_path / "port.npz"), "--device", "cpu"]) == 5
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert got["mu"].dtype == np.float64 and got["sigma"].shape == (2048, 2048)
    scale = np.abs(want["mu"]).max()
    np.testing.assert_allclose(got["mu"], want["mu"], rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(got["sigma"], want["sigma"], rtol=1e-4,
                               atol=1e-5 * np.abs(want["sigma"]).max())
