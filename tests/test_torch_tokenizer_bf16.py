"""bf16 precision of the Stage-I networks against the JAX package's.

Two bf16 computations of one deep network agree no better than either agrees
with float32: their roundings part after a few layers. So a bf16 value of the
port cannot be held against JAX's bf16 value more tightly than the bf16 noise,
and a port that ignored the dtype (running float32) would pass such a check.
What is held here instead is the size of that noise: from the same weights
and inputs, each network's bf16 output and gradients are compared with its own
float32 ones on each side (relative L2 over the whole tensor), and the port's
gap must be between 0.7 and 1.4 times JAX's (measured 0.87-1.02). A port
that ran float32 in bf16's place gives 0; one whose GroupNorms computed
entirely in bf16 gives 1.72 on the discriminator's gradients (1.0-1.23 on
the other cases, so a loss of precision smaller than the bf16 noise itself
passes). So this holds the precision of the port's bf16 path, not its values.
Cases: the encoder's latent, the decoder's reconstruction from fixed +-1
codes and its weights' gradients (of the squared error), the
discriminator's logits and their gradients with respect to its weights and
its input. JAX is compiled with `xla_allow_excess_precision` off, so that it
rounds every bf16 value as PyTorch's ops do; by default XLA keeps some fused
values in float32 (the logits' gap is then 0.86% against 1.28%).

Biases are held apart: XLA's CPU backend reduces a bf16 bias cotangent in
bf16 (the decoder's `conv_out` bias gradient is off by tens of percent), so
JAX is no witness there; the port's bf16 bias gradients are held against its
own float32 ones within a bf16 rounding, and JAX's gap is checked to be the
larger.

The whole bf16 train step is not held value for value: the LFQ's sign
decisions flip under bf16 rounding (7 of 2048 bits on each side, 10 between
the two sides, in the trajectory test's setting), and each flip moves the
reconstruction; with the signs pinned, the step's scalars still differ between
the sides by about as much as from float32. ROADMAP.md, Queue 3, says so.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskbit_tpu.models.tokenizer import ConvVQModel as JaxConvVQModel
from maskbit_tpu.nn import discriminator as jax_disc
from maskbit_tpu_torch.compat.torch_export import export_discriminator_state, export_tokenizer_state
from maskbit_tpu_torch.compat.weights import discriminator_from_flax, tokenizer_from_flax
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from maskbit_tpu_torch.nn.discriminator import create_discriminator
from tests.test_torch_tokenizer_train import B, LFQ, RES, V2

torch.set_num_threads(2)

GAP_RATIO = (0.7, 1.4)
BF16_ROUNDING = 2.0**-7  # relative; one rounding of a float32 result to bf16


def _vec(tree, keep):
    return np.concatenate([np.asarray(v, np.float64).ravel()
                           for k, v in sorted(tree.items()) if keep(k)])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _is_bias(name):
    return name.endswith("bias")


def _compiled(fn):
    """`fn` compiled by XLA with every bf16 value rounded, as PyTorch's ops
    round theirs (by default XLA may keep a fused value in float32)."""
    return jax.jit(fn, compiler_options={"xla_allow_excess_precision": False})


def _jax_readings(dtype, gen_params, disc_params, images, codes):
    model = JaxConvVQModel.from_config(LFQ, dtype=dtype)
    z = _compiled(lambda p, x: model.apply({"params": p}, x, method=lambda m, x: m.encoder(x)))(
        gen_params, jnp.asarray(images))

    def decode_loss(decoder):
        rec = model.apply({"params": dict(gen_params, decoder=decoder)}, jnp.asarray(codes),
                          method="decode")
        return jnp.mean((rec.astype(jnp.float32) - images) ** 2), rec

    (_, rec), grads = _compiled(jax.value_and_grad(decode_loss, has_aux=True))(
        gen_params["decoder"])
    grads = export_tokenizer_state(
        jax.tree.map(np.asarray, dict(gen_params, decoder=grads)), LFQ["codebook_size"])
    disc = jax_disc.create_discriminator(V2, dtype=dtype)

    def disc_loss(params, x):
        logits = disc.apply({"params": params}, x)
        return -jnp.mean(logits.astype(jnp.float32)), logits

    (_, logits), (d_grads, x_grad) = _compiled(
        jax.value_and_grad(disc_loss, argnums=(0, 1), has_aux=True))(disc_params,
                                                                      jnp.asarray(images))
    d_grads = export_discriminator_state(jax.tree.map(np.asarray, d_grads),
                                         V2["blur_kernel_size"])
    dec = {k: v for k, v in grads.items() if k.startswith("decoder.")}
    d_grads = {k: v for k, v in d_grads.items() if not k.endswith(".1.kernel")}  # the blur
    return _readings(z, rec, dec, logits, x_grad, d_grads)


def _port_readings(dtype, gen_params, disc_params, images, codes):
    model = ConvVQModel.from_config(LFQ, dtype=dtype)
    tokenizer_from_flax(gen_params, model, LFQ["codebook_size"])
    x = torch.from_numpy(images)
    with torch.no_grad():
        z = model.encoder(x.permute(0, 3, 1, 2).to(dtype, memory_format=torch.channels_last))
    rec = model.decode(torch.from_numpy(codes))
    torch.mean((rec.float() - x) ** 2).backward()
    dec = {n: p.grad for n, p in model.named_parameters() if n.startswith("decoder.")}
    disc = create_discriminator(V2, dtype=dtype)
    discriminator_from_flax(disc_params, disc)
    x = x.clone().requires_grad_()
    logits = disc(x)
    (-logits.float().mean()).backward()
    d_grads = {n: p.grad for n, p in disc.named_parameters()}
    return _readings(z.permute(0, 2, 3, 1).detach(), rec.detach(), dec, logits.detach(), x.grad,
                     d_grads)


def _readings(z, rec, dec_grads, logits, x_grad, disc_grads):
    f64 = lambda t: np.asarray(t.float() if isinstance(t, torch.Tensor) else t, np.float64)
    weights = lambda k: not _is_bias(k)
    return {
        "latent": f64(z), "reconstruction": f64(rec),
        "decoder_grads": _vec({k: f64(v) for k, v in dec_grads.items()}, weights),
        "logits": f64(logits), "input_grad": f64(x_grad),
        "disc_grads": _vec({k: f64(v) for k, v in disc_grads.items()}, weights),
        "bias_grads": np.concatenate([
            _vec({k: f64(v) for k, v in dec_grads.items()}, _is_bias),
            _vec({k: f64(v) for k, v in disc_grads.items()}, _is_bias)]),
    }


@functools.lru_cache(maxsize=1)
def _all_readings():
    images = np.random.default_rng(11).uniform(size=(B, RES, RES, 3)).astype(np.float32)
    codes = np.where(np.random.default_rng(3).standard_normal((B, RES // 2, RES // 2, 4)) > 0,
                     1.0, -1.0).astype(np.float32)
    gen = JaxConvVQModel.from_config(LFQ).init(jax.random.key(0), jnp.asarray(images))["params"]
    disc = jax_disc.create_discriminator(V2).init(jax.random.key(1),
                                                  jnp.asarray(images))["params"]
    gen_np, disc_np = jax.tree.map(np.asarray, gen), jax.tree.map(np.asarray, disc)
    return {
        ("jax", "f32"): _jax_readings(jnp.float32, gen, disc, images, codes),
        ("jax", "bf16"): _jax_readings(jnp.bfloat16, gen, disc, images, codes),
        ("port", "f32"): _port_readings(torch.float32, gen_np, disc_np, images, codes),
        ("port", "bf16"): _port_readings(torch.bfloat16, gen_np, disc_np, images, codes),
    }


@pytest.mark.parametrize("what", ["latent", "reconstruction", "decoder_grads", "logits",
                                  "input_grad", "disc_grads"])
def test_bf16_gap_matches_jax(what):
    r = _all_readings()
    # float32 on both sides agree, so each side's float32 stands for both
    assert _rel(r["port", "f32"][what], r["jax", "f32"][what]) < 1e-4
    jax_gap = _rel(r["jax", "bf16"][what], r["jax", "f32"][what])
    port_gap = _rel(r["port", "bf16"][what], r["port", "f32"][what])
    assert GAP_RATIO[0] * jax_gap <= port_gap <= GAP_RATIO[1] * jax_gap, (what, port_gap, jax_gap)


def test_bf16_bias_grads_are_one_rounding():
    r = _all_readings()
    port_gap = _rel(r["port", "bf16"]["bias_grads"], r["port", "f32"]["bias_grads"])
    jax_gap = _rel(r["jax", "bf16"]["bias_grads"], r["jax", "f32"]["bias_grads"])
    assert port_gap <= BF16_ROUNDING, port_gap
    assert jax_gap > port_gap, (jax_gap, port_gap)
