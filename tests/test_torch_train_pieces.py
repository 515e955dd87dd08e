"""Port parity: the pieces of the Stage-II train step against the JAX package.

Masking, the MLM loss, the EMA, the seven LR schedules and the optimizer
(clip + AdamW, with gradient accumulation against optax.MultiSteps), each
fed the same numbers as its JAX counterpart. Float32 on both sides; each
tolerance is stated where it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maskbit_tpu.core import ema as jax_ema
from maskbit_tpu.losses.mlm import MLMLossConfig as JaxMLMLossConfig
from maskbit_tpu.losses.mlm import mlm_loss as jax_mlm_loss
from maskbit_tpu.ops import masking as jax_masking
from maskbit_tpu.train.tokenizer_trainer import make_optimizer as jax_make_optimizer
from maskbit_tpu.utils import lr_schedules as jax_lr
from maskbit_tpu_torch.core import ema
from maskbit_tpu_torch.losses.mlm import MLMLossConfig, mlm_loss
from maskbit_tpu_torch.ops import masking
from maskbit_tpu_torch.train.optim import global_norm, make_optimizer
from maskbit_tpu_torch.utils import lr_schedules

torch.set_num_threads(2)


@pytest.mark.parametrize("mode", masking.TRAIN_MODES)
def test_mask_tokens_match_jax(mode):
    """The same uniforms through both: the ratio agrees to float32 rounding
    (XLA's and torch's cos/arccos differ by ulps), the masks exactly."""
    key = jax.random.key(3)
    tokens = np.arange(4 * 10 * 2, dtype=np.int32).reshape(4, 10, 2) % 7
    want_tokens, want_mask = jax_masking.get_mask_tokens(key, jnp.asarray(tokens), 9, mode=mode,
                                                         min_masking_ratio=0.1)
    key_r, key_mask = jax.random.split(key)  # the draws get_mask_tokens makes
    injected = {"mask_ratio_uniform": np.array(jax.random.uniform(key_r, (4,))),
                "mask_token_uniform": np.array(jax.random.uniform(key_mask, tokens.shape))}
    got_tokens, got_mask = masking.get_mask_tokens(torch.from_numpy(tokens), 9, mode=mode,
                                                   min_masking_ratio=0.1, injected=injected)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(got_tokens.numpy(), np.asarray(want_tokens))
    r = np.linspace(0.0, 0.999, 50).astype(np.float32)
    np.testing.assert_allclose(masking.mask_ratio_from_uniform(torch.from_numpy(r), mode).numpy(),
                               np.asarray(jax_masking.mask_ratio_from_uniform(jnp.asarray(r), mode)),
                               rtol=0, atol=3e-7)


def test_mask_tokens_from_a_generator():
    tokens = torch.zeros(64, 16, 2, dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    masked, mask = masking.get_mask_tokens(tokens, 5, generator=gen)
    assert masked.dtype == tokens.dtype and bool((masked[mask] == 5).all())
    assert bool((masked[~mask] == 0).all())
    # arccos schedule: E[ratio] = E[arccos(r)] / (pi/2) = 2/pi
    assert abs(mask.float().mean().item() - 2 / np.pi) < 0.05
    with pytest.raises(ValueError, match="Generator"):
        masking.get_mask_tokens(tokens, 5)


@pytest.mark.parametrize("label_smoothing,sum_splits", [(0.1, False), (0.0, True)])
def test_mlm_loss_matches_jax(label_smoothing, sum_splits):
    """float32 log-softmax and means in both: rtol 1e-6."""
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 12, 2, 8)).astype(np.float32) * 3
    targets = rng.integers(0, 8, size=(3, 12, 2)).astype(np.int32)
    targets[0, :4] = logits[0, :4].argmax(-1)  # some correct predictions
    masks = rng.random((3, 12, 2)) < 0.5
    loss_w, want = jax_mlm_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(masks),
                                JaxMLMLossConfig(label_smoothing, sum_splits))
    loss_g, got = mlm_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                           torch.from_numpy(masks), MLMLossConfig(label_smoothing, sum_splits))
    assert set(got) == set(want)
    np.testing.assert_allclose(loss_g.item(), float(loss_w), rtol=1e-6)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("kwargs", [{}, dict(use_ema_warmup=True, update_after_step=1),
                                    dict(update_every=2, min_decay=0.5)])
def test_ema_matches_jax(kwargs):
    """Five updates of the same parameter sequence: shadows within 1e-6 (the
    decay is a Python float here, float32 in JAX)."""
    rng = np.random.default_rng(2)
    w0 = rng.normal(size=(4, 3)).astype(np.float32)
    model = torch.nn.Linear(3, 4)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(w0))
        model.bias.zero_()
    state = ema.init_ema(model)
    jstate = jax_ema.init_ema({"weight": jnp.asarray(w0), "bias": jnp.zeros(4)})
    for step in range(5):
        new = rng.normal(size=(4, 3)).astype(np.float32)
        with torch.no_grad():
            model.weight.copy_(torch.from_numpy(new))
        ema.ema_update(state, model, decay=0.9, **kwargs)
        jstate = jax_ema.ema_update(jstate, {"weight": jnp.asarray(new), "bias": jnp.zeros(4)},
                                    decay=0.9, **kwargs)
        np.testing.assert_allclose(state.params["weight"].numpy(),
                                   np.asarray(jstate.params["weight"]), atol=1e-6)
        assert state.step == int(jstate.step)
    for s in range(-1, 40, 7):
        np.testing.assert_allclose(ema.ema_decay(s, 0.99, **{k: v for k, v in kwargs.items()
                                                              if k != "update_every"}),
                                   float(jax_ema.ema_decay(jnp.asarray(s), 0.99, **{
                                       k: v for k, v in kwargs.items() if k != "update_every"})),
                                   rtol=1e-6, atol=1e-7)


SCHEDULES = ["constant", "constant_with_warmup", "linear", "cosine", "cosine_with_minimum",
             "cosine_with_restarts", "polynomial"]


@pytest.mark.parametrize("name", SCHEDULES)
def test_lr_schedules_match_jax(name):
    """Every step from 0 past the end: float64 here, float32 in JAX. rtol 1e-5:
    near the end of a cosine its f32 rounding is amplified (cos near 0)."""
    kw = dict(num_warmup_steps=10, num_training_steps=50, num_cycles=2, minimum_rate=0.2)
    got = lr_schedules.get_schedule(name, 3e-4, **kw)
    want = jax_lr.get_schedule(name, 3e-4, **kw)
    for step in range(0, 60):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step))), rtol=1e-5,
                                   atol=1e-12, err_msg=f"{name} step {step}")
    with pytest.raises(ValueError):
        lr_schedules.get_schedule("nope", 1e-4, 1, 2)


def _run_optimizers(k, max_grad_norm, steps=6):
    rng = np.random.default_rng(4)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32), "b": rng.normal(size=(3,)).astype(np.float32)}
    sched = lambda t: 1e-2 * jnp.minimum(1.0, t / 2.0)  # noqa: E731 — warmup: step 0 has lr 0
    tx = jax_make_optimizer(sched, beta1=0.9, beta2=0.96, weight_decay=0.045, epsilon=1e-8,
                            max_grad_norm=max_grad_norm, gradient_accumulation_steps=k)
    jparams = {n: jnp.asarray(v) for n, v in p0.items()}
    jopt = tx.init(jparams)
    tparams = [torch.tensor(p0["a"], requires_grad=True), torch.tensor(p0["b"], requires_grad=True)]
    opt = make_optimizer(tparams, lambda t: 1e-2 * min(1.0, t / 2.0), beta1=0.9, beta2=0.96,
                         weight_decay=0.045, epsilon=1e-8, max_grad_norm=max_grad_norm,
                         gradient_accumulation_steps=k)
    updated = []
    for _ in range(steps):
        g = {n: (rng.normal(size=v.shape) * 3).astype(np.float32) for n, v in p0.items()}
        upd, jopt = tx.update({n: jnp.asarray(v) for n, v in g.items()}, jopt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        updated.append(opt.step([torch.from_numpy(g["a"]), torch.from_numpy(g["b"])]))
        for t, n in zip(tparams, ("a", "b")):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jparams[n]), rtol=1e-5,
                                       atol=1e-6)
    return updated


@pytest.mark.parametrize("k,max_grad_norm", [(1, 1.0), (1, None), (2, 1.0), (1, 1e3)])
def test_optimizer_matches_optax(k, max_grad_norm):
    """Six micro-steps of clip + AdamW (+ MultiSteps at k = 2) with the same
    gradients: parameters within 1e-5 relative (float32 in both, the
    operations in a slightly different order)."""
    updated = _run_optimizers(k, max_grad_norm)
    assert updated == [(i + 1) % k == 0 for i in range(6)]


def test_optimizer_first_step_has_zero_lr_but_decays_nothing():
    """optax semantics: update t uses schedule(t), so with warmup the first
    update moves nothing (lr 0 scales the weight decay too)."""
    p = torch.ones(3, requires_grad=True)
    opt = make_optimizer([p], lambda t: 0.1 * t, weight_decay=0.5)
    opt.step([torch.ones(3)])
    assert torch.equal(p.detach(), torch.ones(3))
    opt.step([torch.ones(3)])
    assert bool((p < 1).all())
    assert abs(global_norm([torch.full((4,), 3.0), torch.full((9,), 4.0 / 3.0)]).item()
               - (36 + 16) ** 0.5) < 1e-5
