"""Port parity: `cli/eval_tokenizer` against the JAX CLI, and the demo.

* `eval_tokenizer` on the synthetic eval batches (the same two batches on
  both sides: the JAX CLI's 8 CPU devices times per-device batch 2 against
  the port's batch 16), with the same tokenizer weights (the port's seeded
  random weights written as a `.bin` and read by both): every metric agrees
  key by key (rtol 1e-5, and atol 1e-6 for the random tokenizer's SSIM near
  0, a mean of float32 values in [-1, 1]; codebook usage and entropy
  exactly), for an LFQ and a VQ tokenizer; `eval_results.json` holds them.
* With `MASKBIT_VGG16_WEIGHTS` naming a (random) torchvision VGG16 file,
  both CLIs score LPIPS with the shipped lin heads and agree on it and on
  every other metric as above (LPIPS rtol 1e-5). The test keeps its old
  name, from when the port refused LPIPS weights. (The CLI with Inception
  weights runs in `tests/test_torch_no_jax.py` and on the card in
  `chip_smoke.py`; the IS and rFID it computes are held against JAX in
  `tests/test_torch_eval.py`.)
* `cli/demo` runs at a tiny size and names its classes.
"""

import json

import numpy as np
import pytest
import torch

from maskbit_tpu.cli import eval_tokenizer as jax_et
from maskbit_tpu_torch.cli import eval_tokenizer as et
from maskbit_tpu_torch.cli.common import build_module, random_init_
from maskbit_tpu_torch.core.checkpoint import save_pretrained
from maskbit_tpu_torch.core.config import load_config
from tests.test_cli_eval_demo import TINY_MLM, TINY_VQ, _cfg

torch.set_num_threads(2)
VQ = dict(TINY_VQ, quantizer_type="lookup", codebook_size=32, token_size=16)


def _weights(tmp_path, vq_cfg) -> str:
    config = load_config(_cfg(tmp_path, "w", {"model.vq_model": vq_cfg}))
    model = build_module(lambda: et.build_tokenizer(config, torch.float32), "cpu")
    random_init_(model, torch.Generator().manual_seed(3))
    path = str(tmp_path / "tokenizer.bin")
    save_pretrained(model, path)
    return path


@pytest.mark.parametrize("vq_cfg", [TINY_VQ, VQ], ids=["lfq", "vq"])
def test_eval_tokenizer_matches_jax(tmp_path, monkeypatch, vq_cfg):
    monkeypatch.setenv("WORKSPACE", str(tmp_path / "ws"))
    monkeypatch.setenv("MASKBIT_EVAL_MAX_BATCHES", "2")
    for var in ("MASKBIT_INCEPTION_WEIGHTS", "MASKBIT_ADM_PB", "MASKBIT_VGG16_WEIGHTS"):
        monkeypatch.delenv(var, raising=False)
    extra = {"model.vq_model": vq_cfg, "experiment.vqgan_checkpoint": _weights(tmp_path, vq_cfg),
             "eval.device": "cpu"}
    want = jax_et.main([f"config={_cfg(tmp_path, 'jax_tok', extra)}"])
    port_extra = dict(extra, **{"training.per_device_batch_size": 16})
    got = et.main([f"config={_cfg(tmp_path, 'port_tok', port_extra)}"])
    assert list(got) == list(want) == ["MAE", "MSE", "PSNR", "SSIM", "CodebookUsage",
                                       "CodebookEntropy"]
    for key in want:
        if key.startswith("Codebook"):
            assert got[key] == want[key], key
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)
    saved = json.load(open(tmp_path / "ws" / "port_tok" / "eval" / "eval_results.json"))
    assert saved == got


def test_eval_tokenizer_refuses_lpips_weights(tmp_path, monkeypatch):
    from maskbit_tpu_torch.losses.lpips import random_vgg16_state

    monkeypatch.setenv("WORKSPACE", str(tmp_path / "ws"))
    monkeypatch.setenv("MASKBIT_EVAL_MAX_BATCHES", "1")
    for var in ("MASKBIT_INCEPTION_WEIGHTS", "MASKBIT_ADM_PB", "MASKBIT_LPIPS_WEIGHTS"):
        monkeypatch.delenv(var, raising=False)
    vgg_path = str(tmp_path / "vgg16.pth")
    torch.save(random_vgg16_state(0), vgg_path)
    monkeypatch.setenv("MASKBIT_VGG16_WEIGHTS", vgg_path)
    extra = {"model.vq_model": VQ, "experiment.vqgan_checkpoint": _weights(tmp_path, VQ),
             "eval.device": "cpu"}
    want = jax_et.main([f"config={_cfg(tmp_path, 'jax_lpips', extra)}"])
    got = et.main([f"config={_cfg(tmp_path, 'lpips', dict(extra, **{'training.per_device_batch_size': 16}))}"])
    assert list(got) == list(want) and "LPIPS" in got
    for key in want:
        if key.startswith("Codebook"):
            assert got[key] == want[key], key
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)


def test_demo_runs_and_names_its_classes(tmp_path):
    from PIL import Image

    from maskbit_tpu_torch.cli import demo

    cfg = _cfg(tmp_path, "demo", {
        "model.mlm_model": TINY_MLM, "demo.num_samples": 2, "demo.labels": [1, 7],
        "demo.output": str(tmp_path / "samples.png"), "demo.device": "cpu",
        "experiment.generator_checkpoint": ""})
    assert demo.main([f"config={cfg}"]) == str(tmp_path / "samples.png")
    assert Image.open(tmp_path / "samples.png").size == (4 * 32, 32)
    assert demo.imagenet_classname(282) == "tiger cat"
    config = load_config(cfg)
    tokenizer = demo.get_tokenizer(config, device="cpu", dtype=torch.float32)
    images = np.random.default_rng(0).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    assert demo.visualize_reconstruction(tokenizer, images).shape == (2 * 32, 3 * 32, 3)
