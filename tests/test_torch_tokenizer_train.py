"""Port parity: the Stage-I train step against the JAX package's.

The same tiny tokenizer (32 px, hidden 32, 2 resolutions, 4-bit LFQ with
its entropy loss at temperature 0.1), PatchGAN discriminator (hidden 32, 1
stage, 4-tap blur),
LPIPS with random VGG16 weights as the perceptual loss (weight 0.1), hinge
+ LeCam 0.001 + entropy annealing, and the same images, through 4 steps with
`discriminator_start=2`: steps 0-1 gated off, 2-3 training the
discriminator. The JAX weights are carried across with `compat.weights`;
both sides in float32, AdamW with epsilon 1e-6 on both. Per step every
logged loss and metric agrees within rtol 1e-4 (atol 1e-6 for values near
0; measured within 1e-5), and after the last step the tokenizer's and
discriminator's parameters, the EMA shadows and the LeCam state within atol
2e-5 (measured up to 1.1e-5; four AdamW steps at lr 1e-3 move a weight by
up to 4e-3). Two choices keep the 4-step comparison well-conditioned, for
both frameworks alike:
  * temperature 0.1: at the flagship's 0.01 the trajectory is chaotic in
    the JAX package itself (a 1e-7 change of the images moves its encoder
    weights by 6e-5 after 4 steps, against 1e-7 at 0.1); the entropy at
    0.01 is held against JAX in `tests/test_torch_stage1_losses.py`;
  * epsilon 1e-6 instead of 1e-8: with 32 channels in 32 groups a conv
    bias before a GroupNorm has a gradient of exactly 0 in exact
    arithmetic, float32 noise of ~1e-10 in practice, and Adam turns that
    noise into a step of +-lr whose sign differs between the frameworks
    (with 1e-8 the parameters end up to 8e-4 apart).
Cases: the v2 discriminator with the adaptive weight (`adopt_weight`) and
without it, the Pix2Pix BatchNorm discriminator, `finetune_decoder`, the VQ
tokenizer with its entropy term, and gradient accumulation 2.
`test_first_step_at_flagship_constants_matches_jax` takes one step at the
flagship's T 0.01 and epsilon 1e-8. The precision of the bf16 path is held in
`tests/test_torch_tokenizer_bf16.py`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maskbit_tpu.losses.lpips import LPIPS as JaxLPIPS
from maskbit_tpu.losses.vqgan import VQGANLossConfig as JaxLossConfig
from maskbit_tpu.models.tokenizer import ConvVQModel as JaxConvVQModel
from maskbit_tpu.nn import discriminator as jax_disc
from maskbit_tpu.train import tokenizer_trainer as jax_trainer
from maskbit_tpu.utils.lr_schedules import get_schedule as jax_get_schedule
from maskbit_tpu_torch.compat.torch_export import export_discriminator_state, export_tokenizer_state
from maskbit_tpu_torch.compat.weights import (
    discriminator_from_flax,
    lpips_from_flax,
    tokenizer_from_flax,
)
from maskbit_tpu_torch.losses.lpips import LPIPS
from maskbit_tpu_torch.losses.vqgan import VQGANLossConfig
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from maskbit_tpu_torch.nn.discriminator import create_discriminator
from maskbit_tpu_torch.train.optim import make_optimizer
from maskbit_tpu_torch.train.tokenizer_trainer import (
    init_tokenizer_train_state,
    make_tokenizer_train_step,
    trainable_parameters,
)
from maskbit_tpu_torch.utils.lr_schedules import get_schedule
from tests.test_cli_eval_demo import TINY_VQ

torch.set_num_threads(2)

B, RES, STEPS = 2, 32, 4
LFQ = dict(TINY_VQ, entropy_loss_weight=0.01, entropy_loss_temperature=0.1)
VQ = dict(TINY_VQ, quantizer_type="lookup", codebook_size=32, token_size=8,
          entropy_loss_weight=0.01, entropy_loss_temperature=0.1)
V2 = {"name": "VQGAN+Discriminator", "num_channels": 3, "num_stages": 1,
      "hidden_channels": 32, "blur_resample": True, "blur_kernel_size": 4}
ORIGINAL = {"name": "Original", "num_channels": 3, "num_stages": 2, "hidden_channels": 16}
LOSSES = dict(perceptual_loss="lpips", perceptual_weight=0.1, reconstruction_weight=1.0,
              discriminator_weight=0.1, discriminator_start=2,
              discriminator_gradient_penalty="adopt_weight", lecam_regularization_weight=0.001,
              entropy_annealing_steps=10, entropy_annealing_factor=1.0)
METRIC_RTOL, METRIC_ATOL, PARAM_ATOL = 1e-4, 1e-6, 2e-5
EPS = 1e-6


def _schedule(warmup):
    return "constant_with_warmup", 1e-3, dict(num_warmup_steps=warmup)


def _jax_side(vq, disc_cfg, losses, finetune, accum, dtype, perceptual_vars, eps=EPS,
              warmup=1):
    name, lr, kw = _schedule(warmup)
    model = JaxConvVQModel.from_config(vq, finetune_decoder=finetune, dtype=dtype)
    disc = jax_disc.create_discriminator(disc_cfg, dtype=dtype)
    gen_tx = jax_trainer.make_optimizer(jax_get_schedule(name, lr, **kw), epsilon=eps,
                                        gradient_accumulation_steps=accum)
    if finetune:
        gen_tx = optax.masked(gen_tx, lambda p: {k: jax.tree.map(lambda _: k == "decoder", v)
                                                 for k, v in p.items()})
    disc_tx = jax_trainer.make_optimizer(jax_get_schedule(name, lr, **kw), epsilon=eps,
                                         gradient_accumulation_steps=accum)
    state = jax.jit(lambda key: jax_trainer.init_tokenizer_train_state(
        model, disc, gen_tx, disc_tx, key, (B, RES, RES, 3)))(jax.random.key(0))
    lpips = JaxLPIPS()
    step = jax.jit(jax_trainer.make_tokenizer_train_step(
        model, disc, gen_tx, disc_tx, JaxLossConfig(**losses),
        perceptual_apply=lambda v, a, b: lpips.apply(v, a, b), ema_kwargs={"decay": 0.999}))
    return state, lambda s, x, i: step(s, jnp.asarray(x), perceptual_vars, jax.random.key(i))


def _port_side(vq, disc_cfg, losses, finetune, accum, dtype, jax_state, perceptual_vars,
               eps=EPS, warmup=1):
    name, lr, kw = _schedule(warmup)
    model = ConvVQModel.from_config(vq, finetune_decoder=finetune, dtype=dtype)
    tokenizer_from_flax(jax.tree.map(np.asarray, jax_state.gen_params), model,
                        vq["codebook_size"])
    disc = create_discriminator(disc_cfg, dtype=dtype)
    discriminator_from_flax(jax.tree.map(np.asarray, jax_state.disc_params), disc)
    gen_opt = make_optimizer(trainable_parameters(model, finetune), get_schedule(name, lr, **kw),
                             epsilon=eps, gradient_accumulation_steps=accum)
    disc_opt = make_optimizer(disc.parameters(), get_schedule(name, lr, **kw), epsilon=eps,
                              gradient_accumulation_steps=accum)
    lpips = lpips_from_flax(jax.tree.map(np.asarray, perceptual_vars), LPIPS())
    state = init_tokenizer_train_state(model, disc, gen_opt, disc_opt)
    step = make_tokenizer_train_step(model, disc, VQGANLossConfig(**losses), perceptual_fn=lpips,
                                     ema_kwargs={"decay": 0.999})
    return state, lambda s, x: step(s, torch.from_numpy(x))


@functools.lru_cache(maxsize=1)
def _perceptual_vars():
    img = jnp.zeros((1, RES, RES, 3))
    return jax.jit(JaxLPIPS().init)(jax.random.key(7), img, img)


def _images():
    rng = np.random.default_rng(11)
    return [rng.uniform(size=(B, RES, RES, 3)).astype(np.float32) for _ in range(STEPS)]


def _run(vq, disc_cfg, losses, finetune=False, accum=1, dtype=(jnp.float32, torch.float32),
         steps=STEPS, eps=EPS, warmup=1):
    pv = _perceptual_vars()
    jstate, jstep = _jax_side(vq, disc_cfg, losses, finetune, accum, dtype[0], pv, eps, warmup)
    tstate, tstep = _port_side(vq, disc_cfg, losses, finetune, accum, dtype[1], jstate, pv, eps,
                               warmup)
    history = []
    for i, images in enumerate(_images()[:steps]):
        jstate, jm = jstep(jstate, images, i)
        tstate, tm = tstep(tstate, images)
        history.append(({k: float(v) for k, v in jm.items()},
                        {k: float(v) for k, v in tm.items()}))
    return jstate, tstate, history


def _close(got, want, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=atol, err_msg=what)


CASES = {
    "v2-adaptive": (LFQ, V2, LOSSES, False, 1),
    "v2": (LFQ, V2, dict(LOSSES, discriminator_gradient_penalty="none"), False, 1),
    "original": (LFQ, ORIGINAL, LOSSES, False, 1),
    "finetune-decoder": (LFQ, V2, LOSSES, True, 1),
    "vq-entropy": (VQ, V2, LOSSES, False, 1),
    "accumulate-2": (LFQ, V2, LOSSES, False, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_trajectory_matches_jax(case):
    vq, disc_cfg, losses, finetune, accum = CASES[case]
    jstate, tstate, history = _run(vq, disc_cfg, losses, finetune, accum)
    for step, (want, got) in enumerate(history):
        assert set(got) == set(want), set(got) ^ set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                       err_msg=f"step {step} {key}")
        gated = step < losses["discriminator_start"]
        assert (want["discriminator_factor"] == 0.0) == gated
        assert (got["discriminator_loss"] == 0.0) == gated
    # the gate: the discriminator's optimizer counts from discriminator_start on
    assert tstate.disc_opt.count == (STEPS - losses["discriminator_start"]) // accum
    # the step differentiates with autograd.grad: no .grad is left anywhere,
    # and the discriminator is trainable again after each step
    assert all(p.grad is None for p in tstate.model.parameters())
    assert all(p.grad is None and p.requires_grad for p in tstate.discriminator.parameters())
    assert tstate.step == STEPS == int(jstate.step)

    want_gen = export_tokenizer_state(jax.tree.map(np.asarray, jstate.gen_params),
                                      vq["codebook_size"])
    got_gen = tstate.model.state_dict()
    for key, value in want_gen.items():
        _close(got_gen[key], value, PARAM_ATOL, key)
    want_ema = export_tokenizer_state(jax.tree.map(np.asarray, jstate.ema.params),
                                      vq["codebook_size"])
    for key, value in tstate.ema.params.items():
        _close(value, want_ema[key], PARAM_ATOL, f"ema {key}")
    taps = disc_cfg.get("blur_kernel_size") if disc_cfg.get("blur_resample") else None
    want_disc = export_discriminator_state(jax.tree.map(np.asarray, jstate.disc_params), taps)
    for key, value in tstate.discriminator.state_dict().items():
        if key.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue  # never read in training
        _close(value, want_disc[key], PARAM_ATOL, f"disc {key}")
    for mine, theirs in zip(tstate.lecam, jstate.lecam):
        np.testing.assert_allclose(float(mine), float(theirs), rtol=METRIC_RTOL, atol=1e-9)
    if finetune:  # the encoder is frozen: equal to its start, bit for bit
        start = export_tokenizer_state(jax.tree.map(np.asarray, _run_init_params(vq)),
                                       vq["codebook_size"])
        for key, value in got_gen.items():
            if key.startswith("encoder."):
                np.testing.assert_array_equal(value.numpy(), start[key])


def _run_init_params(vq):
    pv = _perceptual_vars()
    jstate, _ = _jax_side(vq, V2, LOSSES, True, 1, jnp.float32, pv)
    return jstate.gen_params


def _adam_mu(opt_state):
    """The first moment of the (one) Adam in an optax state."""
    is_adam = lambda s: isinstance(s, optax.ScaleByAdamState)  # noqa: E731
    (adam,) = [s for s in jax.tree.leaves(opt_state, is_leaf=is_adam) if is_adam(s)]
    return jax.tree.map(np.asarray, adam.mu)


def test_first_step_at_flagship_constants_matches_jax():
    """One step at the flagship's entropy temperature 0.01 and AdamW epsilon
    1e-8, with the discriminator and the adaptive weight live from step 0
    and no warmup, so that the first update is a full one. Every metric
    within rtol 1e-4; Adam's first moments (0.1 times the clipped
    gradients) within 3e-4 of each tensor's largest plus 1e-9 (measured:
    up to 1.4e-4 in the encoder, whose gradient passes through the entropy
    at T 0.01, 4e-6 in the decoder; a bias before a one-channel GroupNorm
    has an exact gradient of 0 and float32 noise of 2e-10); the updated
    tokenizer and discriminator within atol 2e-5 wherever |g| > 100 epsilon
    (measured 1.3e-6). A first Adam step moves a weight by
    lr * g / (|g| + epsilon): where |g| is near epsilon, float32 noise in g
    moves it by up to lr, and there only the gradients are compared."""
    eps, b1 = 1e-8, 0.9
    losses = dict(LOSSES, discriminator_start=0)
    jstate, tstate, history = _run(dict(LFQ, entropy_loss_temperature=0.01), V2, losses,
                                   steps=1, eps=eps, warmup=0)
    want, got = history[0]
    assert set(got) == set(want), set(got) ^ set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                   err_msg=key)
    assert want["discriminator_factor"] == 1.0 and got["discriminator_loss"] != 0.0
    sides = (
        (tstate.model, tstate.gen_opt,
         export_tokenizer_state(jax.tree.map(np.asarray, jstate.gen_params),
                                LFQ["codebook_size"]),
         export_tokenizer_state(_adam_mu(jstate.gen_opt), LFQ["codebook_size"])),
        (tstate.discriminator, tstate.disc_opt,
         export_discriminator_state(jax.tree.map(np.asarray, jstate.disc_params)),
         export_discriminator_state(_adam_mu(jstate.disc_opt))),
    )
    for module, opt, want_params, want_mu in sides:
        names = {id(p): n for n, p in module.named_parameters()}
        for p, mu in zip(opt.params, opt.mu):
            key = names[id(p)]
            _close(mu, want_mu[key], 3e-4 * np.abs(want_mu[key]).max() + 1e-9, f"mu {key}")
            steady = np.abs(want_mu[key]) / (1 - b1) > 100 * eps
            _close(p.detach().numpy()[steady], want_params[key][steady], PARAM_ATOL, key)
