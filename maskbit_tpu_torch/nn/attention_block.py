"""Fused postnorm BERT attention block: LN(x + OutProj(MHA(QKV(x)))).

Counterpart of `maskbit_tpu/nn/pallas_attention.fused_attention_block`, in
its signature and layouts: x (b, n, E); wqkv (E, 3E); bqkv (3E,);
wo (E, E); bo, ln_scale, ln_bias (E,).

* A CPU tensor goes to `fused_attention_block_reference`, the plain PyTorch
  version with the kernel's rounding points.
* A CUDA tensor launches the hand-written chain in
  `csrc/attention_block.cu` or raises: bf16 x, wqkv and wo; f32 biases and
  LayerNorm parameters; head dim 64; E a multiple of 8 and at most 4096.
  The weights must be the transposed views of contiguous PyTorch weights
  (`in_proj_weight.t()`, `out_proj.weight.t()`), which is how
  `BertAttention` passes them: the kernel reads the (out, in) layout.

`launches` counts the chain's launches (one per call on a CUDA tensor).
"""

from __future__ import annotations

import ctypes

import torch

launches = 0

HEAD_DIM = 64  # the attention kernel's head width


def fused_attention_block_reference(x, wqkv, bqkv, wo, bo, ln_scale, ln_bias,
                                    num_heads: int, eps: float = 1e-12) -> torch.Tensor:
    """Plain PyTorch version. Products accumulate in f32; qkv, the softmax
    weights and the head outputs are rounded to x's dtype where the TPU
    kernel rounds them; the projection, residual and norm stay f32."""
    b, n, e = x.shape
    d = e // num_heads
    f32 = torch.float32
    qkv = (x.to(f32) @ wqkv.to(f32) + bqkv.to(f32)).to(x.dtype)
    q, k, v = qkv.to(f32).view(b, n, 3, num_heads, d).unbind(2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * d**-0.5
    weights = torch.softmax(logits, dim=-1).to(x.dtype).to(f32)
    attn = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, n, e).to(x.dtype)
    y = x.to(f32) + (attn.to(f32) @ wo.to(f32) + bo.to(f32))
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    return ((y - mu) * torch.rsqrt(var + eps) * ln_scale.to(f32) + ln_bias.to(f32)).to(x.dtype)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch(x, wqkv, bqkv, wo, bo, ln_scale, ln_bias, num_heads, eps):
    from maskbit_tpu_torch.nn.cuda_build import load_library

    b, n, e = x.shape
    if e % num_heads or e // num_heads != HEAD_DIM:
        raise ValueError(f"the kernel needs head dim {HEAD_DIM}, got {e}/{num_heads}")
    if e % 8 or e > 4096:
        raise ValueError(f"the kernel needs E % 8 == 0 and E <= 4096, got {e}")
    dev = x.device
    bf16, f32 = torch.bfloat16, torch.float32
    w_qkv, w_o = wqkv.t(), wo.t()  # the (out, in) layout the kernel reads
    _check("x", x, bf16, (b, n, e), dev)
    _check("wqkv.t()", w_qkv, bf16, (3 * e, e), dev)
    _check("wo.t()", w_o, bf16, (e, e), dev)
    _check("bqkv", bqkv, f32, (3 * e,), dev)
    for name, t in (("bo", bo), ("ln_scale", ln_scale), ("ln_bias", ln_bias)):
        _check(name, t, f32, (e,), dev)

    lib = load_library("attention_block")
    fn = lib.mb_attention_block
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    qkv = torch.empty((b * n, 3 * e), dtype=bf16, device=dev)
    attn = torch.empty((b * n, e), dtype=bf16, device=dev)
    y = torch.empty((b * n, e), dtype=f32, device=dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):  # the runtime launches on the current device
        err = fn(x.data_ptr(), w_qkv.data_ptr(), bqkv.data_ptr(), w_o.data_ptr(),
                 bo.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), qkv.data_ptr(),
                 attn.data_ptr(), y.data_ptr(), out.data_ptr(), b, n, e, num_heads,
                 float(eps), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_block launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out


def fused_attention_block(x, wqkv, bqkv, wo, bo, ln_scale, ln_bias,
                          num_heads: int, eps: float = 1e-12) -> torch.Tensor:
    """Postnorm BERT attention block: LN(x + MHA(x)). x: (b, n, E)."""
    if x.device.type == "cpu":
        return fused_attention_block_reference(
            x, wqkv, bqkv, wo, bo, ln_scale, ln_bias, num_heads, eps)
    if x.device.type == "cuda":
        return _launch(x, wqkv, bqkv, wo, bo, ln_scale, ln_bias, num_heads, eps)
    raise ValueError(f"fused_attention_block: no kernel for device {x.device}")
