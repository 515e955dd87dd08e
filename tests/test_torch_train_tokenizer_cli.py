"""The port's Stage-I training CLI on the CPU, at a tiny size.

Through `maskbit_tpu_torch.cli.train_tokenizer.main` with
`training.device=cpu` (32 px, hidden 32, 2 resolutions, 4-bit LFQ with its
entropy loss at T 0.1, a 1-stage discriminator, synthetic data):
* from `experiment.init_checkpoint`, a `.msgpack` that the JAX package's
  `save_pretrained` wrote, 3 steps with the discriminator gated off, against
  the JAX step on the same weights, batches (the synthetic stream is the
  same for the same seed) and optimizer (the JAX CLI's `build_optimizers`
  on the same config): every logged loss within rtol 1e-4 as in
  `tests/test_torch_tokenizer_train.py` (`gan_loss` excepted: it reads the
  discriminator, which each side initialises from its own generator, and
  enters the total with weight 0 before the gate); the reconstruction grid,
  per-parameter gradient norms every `log_grad_norm_every` steps,
  `eval_every` (PSNR, SSIM, MSE, MAE, codebook usage and entropy, finite),
  `model-3.bin` and `ema_model-3.bin` that load strictly;
* resume from a `save_every` checkpoint with `resume_lr_scheduler: false`
  (both optimizers' counts restart, the moments are kept) and with
  `dont_resume_optimizer: true` (moments and counts restart), the
  discriminator live across the resume;
* a run stopped by SIGTERM saves, and the next run resumes from that step;
* the perceptual loss is off, with the JAX package's warning, when its
  weights are not there, and on when they are;
* `training.device=cuda` without a card raises.
"""

import json
import logging
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from maskbit_tpu.cli.train_tokenizer import build_optimizers as jax_build_optimizers
from maskbit_tpu.core.checkpoint import save_pretrained as jax_save_pretrained
from maskbit_tpu.core.config import Config as JaxConfig
from maskbit_tpu.losses.vqgan import VQGANLossConfig as JaxLossConfig
from maskbit_tpu.models.tokenizer import ConvVQModel as JaxConvVQModel
from maskbit_tpu.nn.discriminator import create_discriminator as jax_create_discriminator
from maskbit_tpu.train import tokenizer_trainer as jax_trainer
from maskbit_tpu_torch.cli import train_tokenizer
from maskbit_tpu_torch.cli.common import build_perceptual, synthetic_batches
from maskbit_tpu_torch.compat.torch_export import export_tokenizer_state
from maskbit_tpu_torch.core.checkpoint import load_pretrained
from maskbit_tpu_torch.core.config import load_config
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from tests.test_cli_eval_demo import DATASET, TINY_VQ

torch.set_num_threads(2)

VQ = dict(TINY_VQ, entropy_loss_weight=0.01, entropy_loss_temperature=0.1)
DISC = {"name": "VQGAN+Discriminator", "num_channels": 3, "num_stages": 1,
        "hidden_channels": 32, "blur_resample": True, "blur_kernel_size": 4}
LOSSES = {"quantizer_weight": 1.0, "perceptual_loss": "none", "perceptual_weight": 0.0,
          "reconstruction_loss": "l2", "reconstruction_weight": 1.0, "discriminator_start": 2,
          "discriminator_loss": "hinge", "discriminator_factor": 1.0,
          "discriminator_weight": 0.1, "discriminator_gradient_penalty": "adopt_weight",
          "lecam_regularization_weight": 0.001, "entropy_annealing_steps": 10,
          "entropy_annealing_factor": 1.0}


def _config(tmp_path, name="cfg", **sections):
    tree = {
        "experiment": {"name": "tok", "output_dir": str(tmp_path / "out"), "logger": "jsonl",
                       "log_every": 1, "save_every": 100, "eval_every": 100,
                       "generate_every": 100, "resume": True},
        "model": {"vq_model": VQ, "discriminator": DISC},
        "losses": LOSSES,
        "dataset": DATASET,
        "optimizer": {"name": "adamw", "params": {"learning_rate": 1e-3, "epsilon": 1e-6,
                                                  "weight_decay": 1e-4}},
        "lr_scheduler": {"scheduler": "constant_with_warmup", "params": {"warmup_steps": 1}},
        "training": {"per_device_batch_size": 2, "mixed_precision": "no", "use_ema": True,
                     "seed": 0, "max_train_steps": 2, "num_generated_images": 1,
                     "max_grad_norm": 1.0, "device": "cpu"},
        "eval": {"max_eval_batches": 1},
    }
    for section, values in sections.items():
        tree[section] = dict(tree[section], **values)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(tree))
    return str(path), tree


def _records(tmp_path):
    path = tmp_path / "out" / "metrics.jsonl"
    return [json.loads(line) for line in open(path)] if path.exists() else []


def test_train_tokenizer_cli_from_a_jax_msgpack_matches_jax(tmp_path):
    steps = 3
    jmodel = JaxConvVQModel.from_config(VQ)
    variables = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    init = str(tmp_path / "init.msgpack")
    jax_save_pretrained(variables["params"], init)
    cfg, tree = _config(tmp_path, experiment={"init_checkpoint": init, "eval_every": steps,
                                              "generate_every": 2, "log_grad_norm_every": 2},
                        losses={"discriminator_start": 100},
                        training={"max_train_steps": steps})
    result = train_tokenizer.main([f"config={cfg}"])
    assert result["steps"] == steps and result["resumed_from"] == 0 and not result["perceptual"]

    # the JAX step on the same weights, batches and optimizer
    jcfg = JaxConfig(tree)
    gen_tx, disc_tx = jax_build_optimizers(jcfg, 1)
    disc = jax_create_discriminator(DISC)
    state = jax.jit(lambda key: jax_trainer.init_tokenizer_train_state(
        jmodel, disc, gen_tx, disc_tx, key, (2, 32, 32, 3)))(jax.random.key(1))
    state = state._replace(gen_params=variables["params"],
                           ema=jax_trainer.init_ema(variables["params"]))
    step = jax.jit(jax_trainer.make_tokenizer_train_step(
        jmodel, disc, gen_tx, disc_tx, JaxLossConfig.from_config(tree["losses"]),
        ema_kwargs={"decay": 0.999}))
    batches = synthetic_batches(2, 32, seed=0)
    history = [r for r in _records(tmp_path) if "total_loss" in r]
    assert [r["step"] for r in history] == list(range(1, steps + 1))
    for record in history:
        state, metrics = step(state, jnp.asarray(next(batches)["image"]), None,
                              jax.random.key(0))
        for key, value in metrics.items():
            if key != "gan_loss":
                np.testing.assert_allclose(record[key], float(value), rtol=1e-4, atol=1e-6,
                                           err_msg=f"step {record['step']} {key}")
        assert record["perf/samples_per_sec_per_device"] > 0

    norms = [r for r in _records(tmp_path) if "grad_norm/decoder.conv_out.weight" in r]
    assert [r["step"] for r in norms] == [2] and all(
        np.isfinite(v) for k, v in norms[0].items() if k.startswith("grad_norm/"))
    evals = [r for r in _records(tmp_path) if "eval/PSNR" in r]
    assert [r["step"] for r in evals] == [steps] and result["evals"][0]["step"] == steps
    for key in ("PSNR", "SSIM", "MSE", "MAE", "CodebookUsage", "CodebookEntropy"):
        assert np.isfinite(evals[0][f"eval/{key}"]), key
    assert os.listdir(tmp_path / "out" / "images")
    for name in (f"model-{steps}.bin", f"ema_model-{steps}.bin"):
        model = ConvVQModel.from_config(VQ)
        model.load_state_dict(load_pretrained(str(tmp_path / "out" / name)), strict=True)
    want = export_tokenizer_state(jax.tree.map(np.asarray, state.gen_params), 16)
    got = torch.load(tmp_path / "out" / f"model-{steps}.bin", weights_only=True)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value, rtol=0, atol=2e-5, err_msg=key)


@pytest.mark.parametrize("opt_out", ["resume_lr_scheduler", "dont_resume_optimizer"])
def test_train_tokenizer_cli_resumes_with_opt_outs(tmp_path, opt_out):
    cfg, _ = _config(tmp_path, experiment={"save_every": 3}, training={"max_train_steps": 3})
    first = train_tokenizer.main([f"config={cfg}"])
    assert first["steps"] == 3
    saved = torch.load(tmp_path / "out" / "checkpoints" / "3" / "state.pt", weights_only=True)
    assert saved["disc_opt"]["count"] == 1 and saved["gen_opt"]["count"] == 3
    flag = ("experiment.resume_lr_scheduler=false" if opt_out == "resume_lr_scheduler"
            else "experiment.dont_resume_optimizer=true")
    second = train_tokenizer.main([f"config={cfg}", "training.max_train_steps=4", flag])
    assert second["resumed_from"] == 3 and second["steps"] == 4
    resumed = torch.load(tmp_path / "out" / "checkpoints" / "4" / "state.pt", weights_only=True)
    # one update after the restart of both counts
    assert resumed["gen_opt"]["count"] == 1 and resumed["disc_opt"]["count"] == 1
    assert resumed["step"] == 4 and resumed["ema"]["step"] == 4
    # nu = 0.999 nu + 0.001 g^2: at least 0.999 of the saved nu when the
    # moments were kept, 0.001 g^2 alone after a fresh start
    kept = all(bool((new >= 0.999 * old * (1 - 1e-6)).all())
               for old, new in zip(saved["gen_opt"]["nu"], resumed["gen_opt"]["nu"]))
    assert kept == (opt_out == "resume_lr_scheduler")
    history = [r for r in _records(tmp_path) if "total_loss" in r]
    assert [r["step"] for r in history] == [1, 2, 3, 4]
    assert history[-1]["discriminator_loss"] != 0.0 and np.isfinite(history[-1]["total_loss"])


def test_train_tokenizer_cli_sigterm_saves_and_resumes(tmp_path):
    cfg, _ = _config(tmp_path, training={"max_train_steps": 100_000, "overfit_batch": True})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "maskbit_tpu_torch.cli.train_tokenizer", f"config={cfg}"]
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    logged = lambda: [r["step"] for r in _records(tmp_path) if "total_loss" in r]  # noqa: E731
    try:
        deadline = time.time() + 240
        while len(logged()) < 3:
            if proc.poll() is not None:
                pytest.fail(f"the CLI exited early rc={proc.returncode}:\n"
                            f"{proc.communicate()[0][-4000:]}")
            if time.time() > deadline:
                pytest.fail("the CLI never reached 3 steps")
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-4000:]
    assert "preemption: stopping cleanly" in out
    ckpt_dir = tmp_path / "out" / "checkpoints"
    saved = max(int(p[len("metadata-"):-len(".json")]) for p in os.listdir(ckpt_dir)
                if p.startswith("metadata-"))
    trained = logged()
    assert saved >= 3 and max(trained) <= saved <= max(trained) + 1
    assert (tmp_path / "out" / f"model-{saved}.bin").exists()
    resumed = subprocess.run(cmd + [f"training.max_train_steps={saved + 1}"], cwd=root, env=env,
                             capture_output=True, text=True, timeout=240)
    assert resumed.returncode == 0, resumed.stdout[-4000:] + resumed.stderr[-4000:]
    assert f"resumed from step {saved}" in resumed.stdout
    assert logged()[len(trained):] == [saved + 1]


def test_perceptual_loss_is_off_only_without_weights(tmp_path, monkeypatch, caplog):
    from maskbit_tpu_torch.losses.lpips import LPIPS, random_vgg16_state
    from maskbit_tpu_torch.losses.perceptual import PerceptualLoss, ResNet50

    logger = logging.getLogger("perceptual-test")
    monkeypatch.delenv("MASKBIT_RESNET50_WEIGHTS", raising=False)
    monkeypatch.delenv("MASKBIT_VGG16_WEIGHTS", raising=False)
    config = load_config(_config(tmp_path, losses={"perceptual_loss": "resnet50",
                                                   "perceptual_weight": 0.1})[0])
    with caplog.at_level(logging.WARNING):
        assert build_perceptual(config, logger, "cpu") is None
    assert "disabling perceptual loss" in caplog.text
    resnet = str(tmp_path / "resnet50.pth")
    torch.save(ResNet50().state_dict(), resnet)
    monkeypatch.setenv("MASKBIT_RESNET50_WEIGHTS", resnet)
    assert isinstance(build_perceptual(config, logger, "cpu"), PerceptualLoss)
    config = load_config(_config(tmp_path, name="lpips", losses={"perceptual_loss": "lpips",
                                                               "perceptual_weight": 0.1})[0])
    assert build_perceptual(config, logger, "cpu") is None
    vgg = str(tmp_path / "vgg16.pth")
    torch.save(random_vgg16_state(0), vgg)
    monkeypatch.setenv("MASKBIT_VGG16_WEIGHTS", vgg)
    assert isinstance(build_perceptual(config, logger, "cpu"), LPIPS)
    config = load_config(_config(tmp_path, name="zero", losses={"perceptual_loss": "lpips",
                                                              "perceptual_weight": 0.0})[0])
    assert build_perceptual(config, logger, "cpu") is None


def test_train_tokenizer_cli_refuses_a_missing_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, _ = _config(tmp_path, training={"device": "cuda"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_tokenizer.main([f"config={cfg}"])
