"""Port parity: the visualisation helpers and trackers, and the per-parameter
gradient norms, on the CPU.

* `make_viz_generated_stage_two`, `make_viz_reconstructed_stage_two` and
  `save_image_grid` against the JAX package's on the same seeded arrays:
  equal uint8 grids and PNG pixels, exactly;
* `create_tracker`: 'none' writes nothing, 'jsonl' writes the records the
  JAX tracker writes (all but the wall-clock `time` field) and the same
  images, and 'tensorboard' or 'wandb' fall back to jsonl alone when their
  package cannot be imported, as in the JAX package;
* `per_param_grad_norms`: one norm a trainable parameter, named by it, whose
  squares sum to the step's global grad norm (float32, rtol 1e-5).
"""

import builtins
import json
import math

import numpy as np
import pytest
import torch
from PIL import Image

from maskbit_tpu.utils import tracker as jax_tracker
from maskbit_tpu.utils import viz as jax_viz
from maskbit_tpu_torch.losses.mlm import MLMLossConfig
from maskbit_tpu_torch.models.generator import LFQBert, init_generator_weights_
from maskbit_tpu_torch.train.generator_trainer import (
    init_generator_train_state,
    make_generator_train_step_from_tokens,
)
from maskbit_tpu_torch.train.optim import make_optimizer
from maskbit_tpu_torch.utils import tracker as port_tracker
from maskbit_tpu_torch.utils import viz as port_viz


@pytest.mark.parametrize("n", [1, 4, 6])
def test_viz_grids_match_jax(tmp_path, n):
    rng = np.random.default_rng(n)
    a = rng.uniform(-0.2, 1.2, size=(n, 8, 8, 3)).astype(np.float32)
    b = rng.uniform(size=(n, 8, 8, 3)).astype(np.float32)
    for port_fn, jax_fn, args in (
            (port_viz.make_viz_generated_stage_two, jax_viz.make_viz_generated_stage_two, (a,)),
            (port_viz.make_viz_reconstructed_stage_two, jax_viz.make_viz_reconstructed_stage_two,
             (a, b))):
        got_images, got = port_fn(*args)
        want_images, want = jax_fn(*args)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        assert [np.asarray(i).tolist() for i in got_images] == [np.asarray(i).tolist()
                                                                for i in want_images]
    port_viz.save_image_grid(got, str(tmp_path / "p.png"))
    jax_viz.save_image_grid(want, str(tmp_path / "j.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "p.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))


def _log(module, out_dir, name):
    t = module.create_tracker(name, str(out_dir))
    t.log({"loss": np.float32(0.5), "perf/samples_per_sec": 3}, 7)
    t.log_image("train/generated", np.full((4, 8, 3), 200, np.uint8), 7)
    t.close()


def _records(path):
    return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in open(path)]


def test_jsonl_tracker_matches_jax(tmp_path):
    _log(port_tracker, tmp_path / "port", "jsonl")
    _log(jax_tracker, tmp_path / "jax", "jsonl")
    assert _records(tmp_path / "port" / "metrics.jsonl") == _records(
        tmp_path / "jax" / "metrics.jsonl") == [{"step": 7, "loss": 0.5,
                                                 "perf/samples_per_sec": 3.0}]
    name = "images/train_generated-000000007.png"
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / name)),
                                  np.asarray(Image.open(tmp_path / "jax" / name)))
    _log(port_tracker, tmp_path / "none", "none")
    assert not (tmp_path / "none").exists()


@pytest.mark.parametrize("name,module", [("tensorboard", "torch.utils.tensorboard"),
                                         ("wandb", "wandb")])
def test_tracker_falls_back_to_jsonl_without_its_package(tmp_path, monkeypatch, name, module):
    real_import = builtins.__import__

    def no_package(mod, *args, **kwargs):
        if mod == module:
            raise ImportError(f"no {mod}")
        return real_import(mod, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_package)
    t = port_tracker.create_tracker(name, str(tmp_path))
    assert [type(x).__name__ for x in t._trackers] == ["JsonlTracker"]
    t.close()


def test_per_param_grad_norms_sum_to_the_global_norm():
    model = LFQBert(img_size=16, hidden_dim=32, codebook_size=16, codebook_splits=2, depth=1,
                    heads=2, mlp_dim=64, dropout=0.1, nclass=10, input_stride=2)
    init_generator_weights_(model, torch.Generator().manual_seed(0))
    state = init_generator_train_state(model, make_optimizer(model.parameters(), lambda t: 1e-3))
    step = make_generator_train_step_from_tokens(model, 16, MLMLossConfig(),
                                                 log_param_grad_norms=True)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 16, (2, 64)))
    _, metrics = step(state, tokens, torch.tensor([1, 2]), torch.Generator().manual_seed(1))
    norms = {k[len("grad_norm/"):]: v for k, v in metrics.items() if k.startswith("grad_norm/")}
    assert list(norms) == [n for n, _ in model.named_parameters()]
    total = math.sqrt(sum(float(v) ** 2 for v in norms.values()))
    assert total == pytest.approx(float(metrics["grad_norm"]), rel=1e-5)
