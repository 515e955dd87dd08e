"""Fused postnorm BERT attention block: LN(x + OutProj(MHA(QKV(x)))).

Counterpart of `maskbit_tpu/nn/pallas_attention.fused_attention_block`, in
its signature and layouts: x (b, n, E); wqkv (E, 3E); bqkv (3E,);
wo (E, E); bo, ln_scale, ln_bias (E,).

* A CPU tensor goes to `fused_attention_block_reference`, the plain PyTorch
  version with the kernel's rounding points.
* A CUDA tensor launches a hand-written chain or raises: x, wqkv and wo
  of one dtype in `dropout_attention.DTYPES`, bf16 (`csrc/attention_block.cu`)
  or float32 (`csrc/attention_f32.cu`: the projections and the attention
  in 3xTF32 on the tensor cores, long sums added in float32 on the CUDA
  cores, within the plain float32 block's error of a float64 one up to E =
  8192; the LayerNorm in float32, as JAX's block computes under
  `training.mixed_precision: no`); the biases and LayerNorm parameters
  each f32 or bf16 (the kernels widen bf16 exactly); any head dim d = E /
  heads and any E (past d = 128 the attention core is, as
  `dropout_attention`'s, the TMA and wgmma kernel of
  `csrc/attention_wide_bf16.cuh` in bf16 and the panelled kernel of
  `csrc/attention_wide.cuh` in float32). The weights must
  be the transposed views of contiguous PyTorch weights
  (`in_proj_weight.t()`, `out_proj.weight.t()`), which is how
  `BertAttention` passes them: the kernels read the (out, in) layout.
* Shapes outside the kernels' native set run padded, exactly
  (`pad_block`): a head dim that is not a multiple of 16 takes the
  instantiation at d rounded up to 16, with W_qkv's rows and bqkv's
  entries zero-padded per head (the QKV projection then writes the padded
  head layout) and W_o's columns likewise; an E that is not a multiple of 8
  (the tensor maps' 16-byte rows) pads x's, W_qkv's and W_o's E-wide sides
  and bo with zeros. The softmax keeps d's scale and the LayerNorm takes
  its mean and variance over the true E. The cost is a copy of the weights
  and x per call, paid only by such shapes.

The chain is the QKV projection, the attention forward of
`nn/dropout_attention.fused_attention` (`attn_fwd_kernel<d, false>` or,
past d = 128, `attn_fwd_wide_bf16_kernel<W, false, ...>`, or their float32
forms (`attn_fwd_wide_kernel<float, false>` past 128),
whose count in `dropout_attention.launches["fused_attention"]`
it adds to), the out-projection with the residual (f32) and the LayerNorm.
`launches` counts the chain's launches in this process (one per call on a
CUDA tensor, also in `dropout_attention.launches_by_dtype` under
"attention_block"); `launch_counts` reads it beside the dropout-attention
kernels' counts and `reset_launch_counts` zeroes them all. The split
sampler's workers (`sampling/serve.py`) count their own, and report them on
request.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from maskbit_tpu_torch.nn import dropout_attention

launches = 0

BLOCK_N = 256  # output columns of a projection block
VECTOR_DTYPES = (torch.float32, torch.bfloat16)


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


def block_widths(e: int, num_heads: int) -> tuple[int, int, int]:
    """(d, the padded head dim, the padded E) of a block of width `e`: the
    kernels run d rounded up to 16 and E rounded up to 8."""
    d = e // num_heads
    return d, dropout_attention.padded_head_dim(d), -(-e // 8) * 8


def pad_block(x, wqkv, bqkv, wo, bo, num_heads: int):
    """x, wqkv, bqkv, wo and bo at `block_widths`' padded widths, in the
    layouts `fused_attention_block` takes (wqkv (E_pad, 3 H d_pad), wo (H
    d_pad, E_pad): the transposed views of contiguous (out, in) weights):
    each head's rows of the QKV projection and columns of the
    out-projection zero-padded from d to d_pad, and every E-wide side
    zero-padded from E to E_pad."""
    b, n, e = x.shape
    h = num_heads
    d, dp, ep = block_widths(e, h)
    x = F.pad(x, (0, ep - e))
    w_qkv = F.pad(wqkv.t().reshape(3, h, d, e), (0, ep - e, 0, dp - d)).reshape(3 * h * dp, ep)
    bqkv = F.pad(bqkv.reshape(3, h, d), (0, dp - d)).reshape(3 * h * dp)
    w_o = F.pad(wo.t().reshape(e, h, d), (0, dp - d, 0, 0, 0, ep - e)).reshape(ep, h * dp)
    return (x.contiguous(), w_qkv.contiguous().t(), bqkv.contiguous(), w_o.contiguous().t(),
            F.pad(bo, (0, ep - e)).contiguous())


def plan(m: int, e: int, sms: int) -> tuple[int, int]:
    """(rows of a QKV block, rows of an out-projection block) for x of
    (m, e) on a card of `sms` SMs: 128 or 64, whichever takes the less
    time in waves x a block's time, with a block of 64 rows taking 3/4 of
    one of 128 (E = 1024 on an H100: 12.1 and 16.1 us a wave). 128 at the
    serving shape (m = 4112) and for the 512 px batch's QKV projection
    (m = 2050); 64 for its out-projection, where 128-row blocks would
    leave the card half empty."""
    def rows(cols: int) -> int:
        col_tiles = -(-cols // BLOCK_N)
        return min((128, 64), key=lambda bm: -(-(-(-m // bm) * col_tiles) // sms) * (bm + 128))

    return rows(3 * e), rows(e)


def _check(name, t, dtypes, shape, device, layout=True):
    """Raises unless t is on `device`, of one of `dtypes` (one or two), of
    `shape`, and (with `layout`) contiguous and 16-byte aligned. Runs on
    every call, so the common case takes one cheap test (dtypes compared by
    identity)."""
    dt = t.dtype
    if (t.device == device and (dt is dtypes[0] or dt is dtypes[-1]) and t.shape == shape
            and (not layout or (t.is_contiguous() and not t.data_ptr() % 16))):
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if dt not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {dt}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    raise ValueError(f"{name} must be contiguous and 16-byte aligned")


_sms: dict[int, int] = {}  # SMs by device index
_plans: dict[tuple, tuple] = {}  # plan by (m, e, SMs)


def _lib():
    from maskbit_tpu_torch.nn.cuda_build import load_library

    fn = load_library("attention_block").mb_attention_block
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.restype = i32
        fn.argtypes = [ptr] * 7 + [i32] + [ptr] * 4 + [i32] * 4 + [ctypes.c_float] + [i32] * 2 + [
            ptr]
    return fn


def _lib_f32():
    """`csrc/attention_f32.cu`'s block: `_lib()`'s arguments with the
    weights' split scratch and without the tile plan."""
    from maskbit_tpu_torch.nn.cuda_build import load_library

    fn = load_library("attention_f32").mb_attention_block_f32
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.restype = i32
        fn.argtypes = [ptr] * 7 + [i32] + [ptr] * 5 + [i32] * 4 + [ctypes.c_float, ptr]
    return fn


def _launch(x, wqkv, bqkv, wo, bo, ln_scale, ln_bias, num_heads, eps, tiles=None):
    """The chain on CUDA tensors. `tiles`: `plan`'s (rows of a QKV block,
    rows of an out-projection block) to use instead of the plan for this
    shape, for measuring the alternatives side by side (bf16 only: the
    float32 chain has one tiling)."""
    b, n, e = x.shape
    if e % num_heads:
        raise ValueError(f"E = {e} is not a multiple of the {num_heads} heads")
    d, dp, ep = block_widths(e, num_heads)
    dropout_attention.check_head_dim(d)
    dev, dt = x.device, x.dtype
    if dt not in dropout_attention.DTYPES:
        raise TypeError(f"x must be bfloat16 or float32, got {dt}")
    same = (dt,)
    padded = dp != d or ep != e
    if padded:  # the originals' layout is not read: only their dtypes and shapes count
        for name, t, dts, shape in (("x", x, same, (b, n, e)), ("wqkv", wqkv, same, (e, 3 * e)),
                                    ("wo", wo, same, (e, e)), ("bqkv", bqkv, VECTOR_DTYPES, (3 * e,)),
                                    ("bo", bo, VECTOR_DTYPES, (e,))):
            _check(name, t, dts, shape, dev, layout=False)
        x, wqkv, bqkv, wo, bo = pad_block(x, wqkv, bqkv, wo, bo, num_heads)
    hq = num_heads * dp  # the attention's padded width
    w_qkv, w_o = wqkv.t(), wo.t()  # the (out, in) layout the kernel reads
    _check("x", x, same, (b, n, ep), dev)
    _check("wqkv.t()", w_qkv, same, (3 * hq, ep), dev)
    _check("wo.t()", w_o, same, (ep, hq), dev)
    vec_bf16 = 0
    for bit, (name, t, size) in enumerate((("bqkv", bqkv, 3 * hq), ("bo", bo, ep),
                                           ("ln_scale", ln_scale, e), ("ln_bias", ln_bias, e))):
        _check(name, t, VECTOR_DTYPES, (size,), dev)
        if t.dtype is torch.bfloat16:
            vec_bf16 |= 1 << bit

    m = b * n
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    # one scratch allocation: qkv (m, 3 hq) and the attention output (m, hq)
    # in x's dtype, y (m, E_pad) f32, and for float32 the weights' TF32
    # halves (hi and lo of the (3 hq, E_pad) and (E_pad, hq) weights, f32)
    width = x.element_size()
    split = 2 * (3 * hq * ep + ep * hq) * 4 if dt is torch.float32 else 0
    scratch = torch.empty((m * (4 * hq * width + 4 * ep) + split,), dtype=torch.uint8, device=dev)
    out = torch.empty((b, n, ep), dtype=dt, device=dev)
    qkv = scratch.data_ptr()
    args = (x.data_ptr(), w_qkv.data_ptr(), bqkv.data_ptr(), w_o.data_ptr(), bo.data_ptr(),
            ln_scale.data_ptr(), ln_bias.data_ptr(), vec_bf16, qkv, qkv + m * hq * 3 * width,
            qkv + m * hq * 4 * width, out.data_ptr())
    if dt is torch.float32:
        fn = _lib_f32()
        args += (qkv + m * (4 * hq * width + 4 * ep), b, n, e, num_heads, float(eps))
    else:
        fn = _lib()
        args += (b, n, e, num_heads, float(eps))
        if idx not in _sms:
            _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
        if tiles is None:
            key = (m, e, _sms[idx])
            tiles = _plans.get(key)
            if tiles is None:
                tiles = _plans[key] = plan(*key)
        args += tuple(tiles)
    if idx == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):  # the runtime launches on the current device
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_block launch failed: CUDA error {err}")
    global launches
    launches += 1
    dropout_attention.count("fused_attention", d, dt)
    dropout_attention.count_dtype("attention_block", d, dt)
    return out if ep == e else out[..., :e]


def launch_counts() -> dict:
    """This process's launches: the block's ("attention_block"), the
    dropout-attention kernels' by name, and all of them by head dim and
    dtype ("by_dtype", keys "<name>@<d>/<dtype>", e.g.
    "attention_block@64/float32") and by head dim over both dtypes
    ("by_head_dim", keys "<name>@<d>")."""
    by_dtype, by_d = {}, {}
    for (key, d, dt), n in sorted(dropout_attention.launches_by_dtype.items()):
        by_dtype[f"{key}@{d}/{dt}"] = n
        by_d[f"{key}@{d}"] = by_d.get(f"{key}@{d}", 0) + n
    return {"attention_block": launches, **dropout_attention.launches,
            "by_head_dim": by_d, "by_dtype": by_dtype}


def reset_launch_counts() -> None:
    """Zero every count `launch_counts` reads."""
    global launches
    launches = 0
    dropout_attention.reset_counts()


def fused_attention_block(x, wqkv, bqkv, wo, bo, ln_scale, ln_bias,
                          num_heads: int, eps: float = 1e-12) -> torch.Tensor:
    """Postnorm BERT attention block: LN(x + MHA(x)). x: (b, n, E)."""
    if x.device.type == "cpu":
        return fused_attention_block_reference(
            x, wqkv, bqkv, wo, bo, ln_scale, ln_bias, num_heads, eps)
    if x.device.type == "cuda":
        return _launch(x, wqkv, bqkv, wo, bo, ln_scale, ln_bias, num_heads, eps)
    raise ValueError(f"fused_attention_block: no kernel for device {x.device}")
