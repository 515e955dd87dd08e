"""The port's train CLI: in-training generation eval and the logged keys.

No JAX parity here: the JAX CLI's sampler fixes a 16x16 grid and raises at
the 8x8 grid these tests use (ROADMAP.md, Queue 3 item 2).
* `generate_every` and `eval_every` at an 8x8 grid (16 px images, stride
  2): the grids are written, and `eval/InceptionScore` is logged at the
  eval step, finite, with tiny random pt-fid Inception weights (the FID
  against `eval.stats_path` uses `GeneratorEvaluator`'s host math, held
  against JAX elsewhere); the rate is logged under the JAX CLI's key
  `perf/samples_per_sec_per_device`.
* An eval draws from a generator of its own: a run that evaluates every
  step takes the same steps (losses) as one that never does; without
  Inception weights the eval is skipped with a log line.
"""

import json
import logging
import math

import pytest
import torch
from PIL import Image

from maskbit_tpu_torch.cli import train_maskbit
from maskbit_tpu_torch.eval.inception import random_inception_state
from tests.test_torch_train_cli import MLM, _config

torch.set_num_threads(2)
GRID_8 = dict(MLM, img_size=16, num_steps=2, guidance_scale=2.0)
# command-line overrides (`_config` takes whole sections)
RES_16 = "dataset.preprocessing.resolution=16"
EVAL = [f"eval.{k}={v}" for k, v in {"num_generation_samples": 4,
                                     "generation_batch_size": 2}.items()]


@pytest.fixture
def inception_weights(tmp_path, monkeypatch):
    path = tmp_path / "pt_inception.pth"
    torch.save(random_inception_state(0), path)
    monkeypatch.setenv("MASKBIT_INCEPTION_WEIGHTS", str(path))
    monkeypatch.delenv("MASKBIT_ADM_PB", raising=False)
    return path


def _logged(tmp_path):
    return [json.loads(line) for line in (tmp_path / "out" / "metrics.jsonl").open()]


def test_generate_and_eval_every_at_an_8x8_grid(tmp_path, inception_weights):
    cfg = _config(tmp_path, GRID_8,
                  training={"max_train_steps": 2, "num_generated_images": 2},
                  experiment={"generate_every": 2, "eval_every": 2})
    result = train_maskbit.main([f"config={cfg}", RES_16, *EVAL])
    assert result["steps"] == 2
    images = tmp_path / "out" / "images"
    assert Image.open(images / "train_generated-000000002.png").size == (4 * 16, 16)
    assert Image.open(images / "train_decoded-000000002.png").size == (2 * 16, 2 * 16)
    logged = _logged(tmp_path)
    evals = [r for r in logged if any(k.startswith("eval/") for k in r)]
    assert [r["step"] for r in evals] == [2]
    # no eval.stats_path: the IS alone (a 2048-wide sqrtm costs ~20 CPU-seconds)
    assert "eval/InceptionScore" in evals[0] and "eval/FID" not in evals[0]
    assert math.isfinite(evals[0]["eval/InceptionScore"])
    rates = [r["perf/samples_per_sec_per_device"] for r in logged if "mlm_loss" in r]
    assert len(rates) == 2 and all(r > 0 for r in rates)
    assert not any("perf/samples_per_sec" in r for r in logged)


def test_eval_leaves_the_step_stream_alone(tmp_path, inception_weights, monkeypatch):
    args = [RES_16, *EVAL]
    runs = {}
    for every in (1, 100):
        out = tmp_path / str(every)
        out.mkdir()
        cfg = _config(out, GRID_8, training={"max_train_steps": 3},
                      experiment={"generate_every": 100, "eval_every": every})
        runs[every] = train_maskbit.main([f"config={cfg}", *args])
    assert [h["mlm_loss"] for h in runs[1]["history"]] == [
        h["mlm_loss"] for h in runs[100]["history"]]
    assert sum("eval/InceptionScore" in r for r in _logged(tmp_path / "1")) == 3

    monkeypatch.delenv("MASKBIT_INCEPTION_WEIGHTS")
    messages = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    train_maskbit._logger().addHandler(handler)
    try:
        out = tmp_path / "skip"
        out.mkdir()
        cfg = _config(out, GRID_8, training={"max_train_steps": 1},
                      experiment={"generate_every": 100, "eval_every": 1})
        train_maskbit.main([f"config={cfg}", *args])
    finally:
        train_maskbit._logger().removeHandler(handler)
    assert any(m.startswith("in-training generation eval skipped") for m in messages)
    assert not any(k.startswith("eval/") for r in _logged(out) for k in r)
