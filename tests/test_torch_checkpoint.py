"""The port's train-state checkpoints (`core.checkpoint.CheckpointManager`).

On the CPU at a tiny size (LFQBert depth 2, hidden 64):
* a train state after a few steps (moments, EMA, counts, and with gradient
  accumulation the accumulator and `mini_step`) saved and restored into a
  fresh state is equal bit for bit, and the restored run's next step equals
  the saved run's next step bit for bit;
* `max_to_keep` keeps the newest steps and their metadata only;
* a step whose write failed leaves no metadata and no step directory;
* the resume opt-outs: `resume_lr_scheduler: false` zeroes `count` and
  `mini_step` and keeps the moments, as the JAX package's
  `reset_optimizer_counts` does to an optax state; `dont_resume_optimizer:
  true` gives a fresh optimizer's state, as optax's `tx.init`.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskbit_tpu.cli.common import reset_optimizer_counts as jax_reset_counts
from maskbit_tpu.train.tokenizer_trainer import make_optimizer as jax_make_optimizer
from maskbit_tpu_torch.cli import train_maskbit
from maskbit_tpu_torch.cli.common import reset_optimizer_counts
from maskbit_tpu_torch.core import checkpoint as ckpt_module
from maskbit_tpu_torch.core.checkpoint import CheckpointManager
from maskbit_tpu_torch.core.config import Config
from maskbit_tpu_torch.losses.mlm import MLMLossConfig
from maskbit_tpu_torch.models.generator import LFQBert, init_generator_weights_
from maskbit_tpu_torch.train.generator_trainer import (
    init_generator_train_state,
    make_generator_train_step_from_tokens,
)
from maskbit_tpu_torch.train.optim import make_optimizer

torch.set_num_threads(2)
MLM = dict(img_size=16, hidden_dim=64, codebook_size=16, codebook_splits=2, depth=2, heads=1,
           mlp_dim=128, dropout=0.1, nclass=10, input_stride=2, attention_dropout=0.1,
           fused_attention_dropout=True)


def _state(seed, accumulation=1):
    model = LFQBert(**MLM)
    init_generator_weights_(model, torch.Generator().manual_seed(seed))
    opt = make_optimizer(model.parameters(), lambda t: 1e-3 * (t + 1), beta2=0.96,
                         gradient_accumulation_steps=accumulation)
    return init_generator_train_state(model, opt)


def _train(state, steps, seed=0):
    step = make_generator_train_step_from_tokens(state.model, 16, MLMLossConfig())
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        tokens = torch.from_numpy(rng.integers(0, 16, (3, 64)))
        labels = torch.from_numpy(rng.integers(0, 10, (3,)))
        state, metrics = step(state, tokens, labels, gen)
    return state, metrics


def _flat(state):
    sd = state.state_dict()
    out = {f"params/{k}": v for k, v in sd["params"].items()}
    for key in ("mu", "nu", "acc"):
        for i, t in enumerate(sd["opt"][key] or []):
            out[f"{key}/{i}"] = t
    out.update({f"ema/{k}": v for k, v in sd["ema"]["params"].items()})
    counts = (sd["step"], sd["opt"]["count"], sd["opt"]["mini_step"], sd["ema"]["step"])
    return {k: v.clone() for k, v in out.items()}, counts


@pytest.mark.parametrize("accumulation", [1, 2])
def test_round_trip_is_bit_for_bit(tmp_path, accumulation):
    saved, _ = _train(_state(0, accumulation), 3)
    want, want_counts = _flat(saved)
    assert want_counts == (3, 3 // accumulation, 3 % accumulation, 3)
    mgr = CheckpointManager(str(tmp_path / "checkpoints"))
    mgr.save(3, saved)
    mgr.close()
    assert mgr.latest_step() == 3
    assert json.loads((tmp_path / "checkpoints" / "metadata-3.json").read_text()) == {
        "global_step": 3}

    fresh = _state(1, accumulation)
    assert not torch.equal(fresh.model.input_proj.weight, saved.model.input_proj.weight)
    restored, step = CheckpointManager(str(tmp_path / "checkpoints")).restore_latest(fresh)
    assert step == 3 and restored is fresh
    got, got_counts = _flat(fresh)
    assert got_counts == want_counts and got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the next step from the restored state is the saved run's next step
    _, m_saved = _train(saved, 1, seed=9)
    _, m_fresh = _train(fresh, 1, seed=9)
    assert m_saved["mlm_loss"].item() == m_fresh["mlm_loss"].item()
    for (k, a), b in zip(_flat(saved)[0].items(), _flat(fresh)[0].values()):
        assert torch.equal(a, b), k


def test_max_to_keep_prunes_steps_and_their_metadata(tmp_path):
    state = _state(0)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore_latest(state) is None
    for step in range(1, 6):
        state.step = step
        mgr.save(step, state)
        # the step in flight has no metadata until it has committed
        assert not (tmp_path / f"metadata-{step}.json").exists()
    mgr.wait()
    assert mgr.all_steps() == [4, 5]
    assert sorted(p for p in os.listdir(tmp_path) if p.startswith("metadata-")) == [
        "metadata-4.json", "metadata-5.json"]
    assert [t["step"] for t in mgr.timings] == [1, 2, 3, 4, 5]
    assert all(t["write_s"] >= 0 and t["host_copy_s"] >= 0 for t in mgr.timings)


def test_a_failed_write_leaves_no_step_and_no_metadata(tmp_path, monkeypatch):
    state = _state(0)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    mgr.save(1, state, blocking=True)

    def disk_full(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_module.torch, "save", disk_full)
    mgr.save(2, state)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        mgr.wait()
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1
    assert not (tmp_path / "metadata-2.json").exists() and not (tmp_path / "2").exists()
    monkeypatch.undo()
    assert ".tmp-2" in os.listdir(tmp_path)
    CheckpointManager(str(tmp_path))  # a new manager clears the write cut short
    assert ".tmp-2" not in os.listdir(tmp_path)


def _jax_opt_state():
    tx = jax_make_optimizer(lambda t: 1e-3, max_grad_norm=1.0, gradient_accumulation_steps=2)
    params = {"w": jnp.ones((3,))}
    state = tx.init(params)
    for _ in range(3):
        _, state = tx.update({"w": jnp.full((3,), 0.5)}, state, params)
    return tx, params, state


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("opt_out", ["resume_lr_scheduler", "dont_resume_optimizer"])
def test_resume_opt_outs(tmp_path, opt_out):
    saved, _ = _train(_state(0, accumulation=2), 3)
    want, _ = _flat(saved)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, saved, blocking=True)
    config = Config({"experiment": {"resume": True, opt_out: opt_out != "resume_lr_scheduler"}})
    fresh = _state(1, accumulation=2)
    assert train_maskbit.restore(config, logging.getLogger("test"), mgr, fresh) == 3
    got, (step, count, mini_step, ema_step) = _flat(fresh)
    assert (step, count, mini_step, ema_step) == (3, 0, 0, 3)
    for k in want:
        kept = not (opt_out == "dont_resume_optimizer" and k.split("/")[0] in ("mu", "nu", "acc"))
        assert torch.equal(got[k], want[k] if kept else torch.zeros_like(want[k])), k

    # the JAX package's semantics on an optax state: counts zeroed, moments kept
    tx, params, jstate = _jax_opt_state()
    before, after = _leaves(jstate), _leaves(jax_reset_counts(jstate))
    fresh_jax = _leaves(tx.init(params))
    for k, v in before.items():
        if any(name in k for name in ("count", "gradient_step", "mini_step")):
            assert after[k] == 0 and fresh_jax[k] == 0, k
        else:
            np.testing.assert_array_equal(after[k], v, err_msg=k)
            assert not np.any(fresh_jax[k]), k
    assert reset_optimizer_counts(fresh.opt) is fresh.opt


def test_resume_off_or_nothing_saved_starts_at_zero(tmp_path):
    state = _state(0)
    mgr = CheckpointManager(str(tmp_path))
    log = logging.getLogger("test")
    assert train_maskbit.restore(Config({"experiment": {"resume": True}}), log, mgr, state) == 0
    mgr.save(2, _train(_state(1), 2)[0], blocking=True)
    assert train_maskbit.restore(Config({"experiment": {"resume": False}}), log, mgr, state) == 0
    assert state.step == 0
