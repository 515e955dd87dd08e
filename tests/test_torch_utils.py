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
  squares sum to the step's global grad norm (float32, rtol 1e-5);
* `utils/logger.setup_logger`: a local log file and a `scheme://` one
  through fsspec's buffered stream, as the JAX package's tests hold its
  logger, and nothing emitted where the process is not the main one;
  `utils/meter.AverageMeter` against the JAX package's on the same
  updates; `utils/params.summarize_params`: the generator's total equal to
  the JAX package's count of the same model's Flax parameters.
"""

import builtins
import json
import math

import numpy as np
import pytest
import torch
from PIL import Image

from maskbit_tpu.utils import tracker as jax_tracker
from maskbit_tpu.utils.meter import AverageMeter as JaxAverageMeter
from maskbit_tpu.utils import viz as jax_viz
from maskbit_tpu_torch.losses.mlm import MLMLossConfig
from maskbit_tpu_torch.models.generator import LFQBert, init_generator_weights_
from maskbit_tpu_torch.train.generator_trainer import (
    init_generator_train_state,
    make_generator_train_step_from_tokens,
)
from maskbit_tpu_torch.train.optim import make_optimizer
from maskbit_tpu_torch.utils import logger as port_logger
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


def test_logger_writes_local_and_remote_files_from_the_main_process_only(tmp_path,
                                                                         monkeypatch):
    import fsspec

    path = tmp_path / "sub" / "run.log"
    url = "memory://port_logs/run.log"
    local = port_logger.setup_logger("port_t_local", output_file=str(path))
    remote = port_logger.setup_logger("port_t_remote", output_file=url)
    local.info("hello local")
    remote.warning("hello remote")
    monkeypatch.setattr(port_logger, "is_main_process", lambda: False)
    local.info("from another rank")
    remote.warning("from another rank")
    for h in local.handlers:
        h.flush()
    assert path.read_text().splitlines()[-1].endswith("hello local")
    port_logger._cached_log_stream(url).close()  # committed on close, as at exit
    data = fsspec.filesystem("memory").cat("/port_logs/run.log").decode()
    assert "hello remote" in data and "another rank" not in data
    port_logger._cached_log_stream.cache_clear()


def test_meter_and_param_summary_match_jax():
    import jax
    import jax.numpy as jnp

    from maskbit_tpu.models.generator import LFQBert as JaxLFQBert
    from maskbit_tpu.utils.params import count_params as jax_count_params
    from maskbit_tpu_torch.utils.meter import AverageMeter
    from maskbit_tpu_torch.utils.params import count_params, summarize_params

    mine, theirs = AverageMeter(), JaxAverageMeter()
    for val, n in ((0.5, 1), (2.0, 3), (-1.25, 2)):
        mine.update(val, n)
        theirs.update(val, n)
        assert vars(mine) == vars(theirs)
    cfg = {"hidden_dim": 32, "depth": 1, "heads": 2, "mlp_dim": 64, "codebook_splits": 2,
           "img_size": 16, "input_stride": 2, "nclass": 10}
    vq = {"codebook_size": 16, "token_size": 4}
    model = LFQBert.from_config(cfg, vq)
    jmodel = JaxLFQBert.from_config(cfg, vq)
    tokens = jnp.zeros((1, jmodel.seq_len, 2), jnp.int32)
    params = jax.eval_shape(jmodel.init, jax.random.key(0), tokens, jnp.zeros((1,), jnp.int32))
    assert count_params(model) == jax_count_params(params["params"])
    lines = summarize_params(model, "generator").splitlines()
    assert lines[0] == f"generator: {count_params(model) / 1e6:.2f}M params"
    tops = {name.split(".")[0] for name, _ in model.named_parameters()}
    assert [line.split(":")[0].strip() for line in lines[1:]] == sorted(tops)
