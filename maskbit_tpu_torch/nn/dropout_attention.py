"""Training attention with in-kernel attention-probability dropout.

Counterpart of `maskbit_tpu/nn/pallas_attention.py`'s `dropout_attention`
(its custom-VJP forward and backward kernels) and `fused_attention`, in
their signatures and layouts: q, k, v (b, n, h, d); seeds (b, h), one 32-bit
seed per (batch, head); out (b, n, h, d).

The keep mask is the TPU kernel's, bit for bit: keep iff
murmur3_fmix(row * 0x9E3779B1 + col * 0x85EBCA77 + seed * 0xC2B2AE3D) >=
min(floor(rate * 2^32), 2^32 - 1), uint32 arithmetic, row and col the
query and key indices (`hash_keep_mask`, `hash_keep_mask_np`). Kept softmax
weights are scaled by 1/(1 - rate), dropped ones are 0.

* A CPU tensor takes the plain PyTorch versions (`*_reference`), which keep
  the TPU kernels' rounding points: f32 softmax, the dropped weights rounded
  to the input dtype before the value product, and in the backward the
  score gradient rounded before dq and dk.
* A CUDA tensor launches the hand-written kernels or raises: q, k, v of
  one dtype in `DTYPES` with the same strides and a contiguous last
  dimension (the QKV projection's view qualifies), any head dim d >= 1 (as
  the JAX kernels), 0 <= rate < 1. Up to d = 128 the kernels are
  templates instantiated at the multiples of 16 (`HEAD_DIMS`). Past 128,
  bf16 runs the TMA and wgmma kernels of `csrc/attention_wide_bf16.cuh`,
  float32 the 3xTF32 ones of `csrc/attention_wide_f32.cuh` (both
  instantiated at widths 192 and 256, their forward blocks holding the
  whole output row up to d = 256 and output panels of `WIDE_PANEL`
  columns past it; the float32 backward writes dk and dv in panels of
  `PANEL` columns); `head_panels` gives the panels, each panel's blocks
  summing the scores over all of d. Every d runs at d
  rounded up to 16 (`padded_head_dim`) on inputs the wrapper zero-pads
  per head where d is not a multiple of 16 (zero columns of q and k add
  nothing to the scores, zero columns of v give output columns that are
  sliced away; the softmax scale stays d^-0.5, passed apart from the
  padded width), exact in either dtype, for a copy of the inputs per call.
  bf16 takes `csrc/dropout_attention.cu` (up to 128 one TMA + wgmma
  kernel template on the head dim), float32 (the compute dtype of
  `training.mixed_precision: no`) `csrc/attention_f32.cu` (both passes in
  3xTF32 on the tensor cores); outputs and gradients take the inputs'
  dtype.

`launches` counts kernel launches on CUDA tensors, by kernel:
"dropout_attention_fwd", "dropout_attention_bwd" (one per backward, three
CUDA kernels) and "fused_attention", in this process (`count` adds to it),
and `launches_by_dtype` the same by (kernel, head dim, dtype name), where
the attention block counts its own launches too; the split sampler's
workers (`sampling/serve.py`) count their own.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

# the head dims the narrow kernel templates are instantiated at: sm90.cuh's
# MB_HEAD_DIMS; they take every d in [1, 128], the others zero-padded to the
# next of these
HEAD_DIMS = range(16, 129, 16)
# past 128 (from WIDE_MIN_HEAD_DIM, csrc/attention_wide.cuh's WIDE_MIN_D) d
# is padded to a multiple of 16 and written in column panels
# (`head_panels`): whole up to 256 and in panels of WIDE_PANEL past it
# (csrc/attention_wide_bf16.cuh's WB_PANEL, csrc/attention_wide_f32.cuh's
# WF_PANEL), but float32's dk and dv in panels of PANEL
# (attention_wide_f32.cuh's WB_GRAD_PANEL: a block's two warpgroups each sum
# PANEL columns of one of them)
WIDE_MIN_HEAD_DIM = 129
PANEL = 128
WIDE_PANEL = 256
# the input dtypes the kernels take: JAX's compute dtypes (resolve_compute_dtype)
DTYPES = (torch.bfloat16, torch.float32)
TILE = 64  # queries or keys per kernel tile
# The backward sums dq over a head's key tiles in a fixed order. Up to this
# many tiles (n <= 4096) each key tile starts at its own query tile, so the
# blocks of a head seldom wait for each other, but a block may wait for one
# launched after it: all of a head's blocks must fit on the card at once.
# Longer sequences sum in key-tile order, where a block waits only for
# blocks launched before it.
ROTATE_MAX_TILES = 64
launches = {"dropout_attention_fwd": 0, "dropout_attention_bwd": 0, "fused_attention": 0}
launches_by_dtype: dict[tuple[str, int, str], int] = {}

_MASK32 = 0xFFFFFFFF


def count(key: str, head_dim: int, dtype: torch.dtype) -> None:
    """One launch more of `key` in `launches` and at (head_dim, dtype) in
    `launches_by_dtype`."""
    launches[key] += 1
    count_dtype(key, head_dim, dtype)


def count_dtype(key: str, head_dim: int, dtype: torch.dtype) -> None:
    """One launch more of `key` at (head_dim, dtype) in `launches_by_dtype`."""
    at = (key, head_dim, str(dtype).removeprefix("torch."))
    launches_by_dtype[at] = launches_by_dtype.get(at, 0) + 1


def reset_counts() -> None:
    """Zero `launches` and empty `launches_by_dtype`."""
    for key in launches:
        launches[key] = 0
    launches_by_dtype.clear()


def check_head_dim(d: int) -> None:
    """Raises unless the kernels take head dim `d`: any d >= 1."""
    if d < 1:
        raise ValueError(f"the kernels need a head dim of at least 1, got {d}")


def padded_head_dim(d: int) -> int:
    """The width the kernels run head dim `d` at: d rounded up to 16 (up to
    128 the instantiation at that width)."""
    return -(-d // 16) * 16


def head_panels(d: int, dtype: torch.dtype = torch.bfloat16, dkdv: bool = False) -> list:
    """The output column panels, (first column, width), that the kernels'
    blocks write at head dim `d` in `dtype`, over its padded width: of out
    and dq, or with `dkdv` of dk and dv. One panel where a block holds the
    whole row (up to 256, but up to 128 for float32's dk and dv), else
    `WIDE_PANEL`-wide ones (`PANEL`-wide for float32's dk and dv), the last
    narrower where the padded width is not a multiple of the panel; each
    panel's blocks sum the scores over all of d."""
    dp = padded_head_dim(d)
    panel = PANEL if dkdv and dtype is torch.float32 else WIDE_PANEL
    if d <= panel:
        return [(0, dp)]
    return [(c, min(panel, dp - c)) for c in range(0, dp, panel)]


def keep_threshold(rate: float) -> int:
    """The keep threshold, computed on the host as the TPU kernel does."""
    return min(int(rate * 2**32), 2**32 - 1)


def _check_rate(rate: float) -> float:
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return rate


# ------------------------------------------------------------------ mask ----

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 `a` in [0, 2^32), without int64 overflow."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK32


def hash_keep_mask(seeds: torch.Tensor, n: int, rate: float) -> torch.Tensor:
    """Keep mask (*seeds.shape, n, n), bool: [..., row, col] for the query
    `row` and key `col` of each seed's (batch, head) slot."""
    seeds = torch.as_tensor(seeds)
    dev = seeds.device
    s = seeds.to(torch.int64) & _MASK32
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    mix = (_mul32(idx, 0x9E3779B1)[:, None] + _mul32(idx, 0x85EBCA77)[None, :]
           + _mul32(s, 0xC2B2AE3D)[..., None, None]) & _MASK32
    mix = mix ^ (mix >> 16)
    mix = _mul32(mix, 0x85EBCA6B)
    mix = mix ^ (mix >> 13)
    mix = _mul32(mix, 0xC2B2AE35)
    mix = mix ^ (mix >> 16)
    return mix >= keep_threshold(rate)


def hash_keep_mask_np(n_pad: int, rate: float, seed: int) -> np.ndarray:
    """Numpy copy of `maskbit_tpu.nn.pallas_attention.hash_keep_mask_np`:
    the (n_pad, n_pad) keep mask of one seed."""
    thr = np.uint32(keep_threshold(rate))
    rows = np.arange(n_pad, dtype=np.uint32)[:, None]
    cols = np.arange(n_pad, dtype=np.uint32)[None, :]
    with np.errstate(over="ignore"):
        mix = (rows * np.uint32(0x9E3779B1) + cols * np.uint32(0x85EBCA77)
               + np.uint32(np.int64(seed) & _MASK32) * np.uint32(0xC2B2AE3D))
        mix = mix ^ (mix >> np.uint32(16))
        mix = mix * np.uint32(0x85EBCA6B)
        mix = mix ^ (mix >> np.uint32(13))
        mix = mix * np.uint32(0xC2B2AE35)
        mix = mix ^ (mix >> np.uint32(16))
    return mix >= thr


# -------------------------------------------------------- plain versions ----

def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in float32, or wider if it already is (float64 checks exactness)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _softmax_f32(q, k, scale=None):
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", _wide(q), _wide(k)) * scale
    return torch.softmax(logits, dim=-1)


def _dropped(w, keep, rate):
    return torch.where(keep, w * (1.0 / (1.0 - rate)), torch.zeros((), dtype=w.dtype,
                                                                     device=w.device))


def dropout_attention_reference(q, k, v, seeds, rate: float, scale=None) -> torch.Tensor:
    """Plain forward: f32 softmax, hash mask, dropped weights rounded to
    v's dtype, f32 value product, output in q's dtype. `scale`: the
    softmax scale, d^-0.5 by default (the kernels' padded calls keep the
    unpadded d's)."""
    rate = _check_rate(rate)
    w = _softmax_f32(q, k, scale)
    w = _dropped(w, hash_keep_mask(seeds.to(w.device), q.shape[1], rate), rate)
    out = torch.einsum("bhqk,bkhd->bqhd", _wide(w.to(v.dtype)), _wide(v))
    return out.to(q.dtype)


def dropout_attention_backward_reference(q, k, v, g, seeds, rate: float, scale=None):
    """Plain backward, the TPU kernel's formula: recompute the softmax and
    the mask; dv = dropped^T g; dw = keep (g v^T) / (1 - p);
    dlog = P (dw - rowsum(dw P)) * scale (d^-0.5 by default), rounded to
    q's dtype; dq = dlog k; dk = dlog^T q."""
    rate = _check_rate(rate)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    w = _softmax_f32(q, k, scale)
    keep = hash_keep_mask(seeds.to(w.device), q.shape[1], rate)
    dropped = _wide(_dropped(w, keep, rate).to(v.dtype))
    dv = torch.einsum("bhqk,bqhd->bkhd", dropped, _wide(g))
    dw = _dropped(torch.einsum("bqhd,bkhd->bhqk", _wide(g), _wide(v)), keep, rate)
    dlog = w * (dw - (dw * w).sum(-1, keepdim=True))
    dlog = _wide((dlog * scale).to(q.dtype))
    dq = torch.einsum("bhqk,bkhd->bqhd", dlog, _wide(k))
    dk = torch.einsum("bhqk,bqhd->bkhd", dlog, _wide(q))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def panel_reference(q, k, v, g, seeds, rate: float, panel, scale=None):
    """What one output panel's blocks compute, plainly: the weights from
    scores over the whole of d, then only the columns `panel` = (first
    column, width) of out and, where `g` is given, of dq, dk and dv (the
    incoming gradient's full width enters dP = g v^T). `seeds` None: no
    dropout. Rounding points and `scale` as the whole-width versions'."""
    c0, w = panel
    cols = slice(c0, c0 + w)
    rate = _check_rate(rate)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    p = _softmax_f32(q, k, scale)
    keep = (torch.ones_like(p, dtype=torch.bool) if seeds is None
            else hash_keep_mask(seeds.to(p.device), q.shape[1], rate))
    dropped = _wide(_dropped(p, keep, rate).to(v.dtype))
    out = torch.einsum("bhqk,bkhd->bqhd", dropped, _wide(v[..., cols])).to(q.dtype)
    if g is None:
        return out
    dv = torch.einsum("bhqk,bqhd->bkhd", dropped, _wide(g[..., cols]))
    dw = _dropped(torch.einsum("bqhd,bkhd->bhqk", _wide(g), _wide(v)), keep, rate)
    dlog = _wide((p * (dw - (dw * p).sum(-1, keepdim=True)) * scale).to(q.dtype))
    dq = torch.einsum("bhqk,bkhd->bqhd", dlog, _wide(k[..., cols]))
    dk = torch.einsum("bhqk,bqhd->bkhd", dlog, _wide(q[..., cols]))
    return out, dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def fused_attention_reference(q, k, v, scale=None) -> torch.Tensor:
    """Plain dropout-free attention: f32 softmax, weights rounded to v's
    dtype, f32 value product; `scale` as `dropout_attention_reference`'s."""
    w = _softmax_f32(q, k, scale)
    out = torch.einsum("bhqk,bkhd->bqhd", _wide(w.to(v.dtype)), _wide(v))
    return out.to(q.dtype)


# --------------------------------------------------------------- kernels ----

def seeds_as_int32(seeds: torch.Tensor, shape) -> torch.Tensor:
    """(b, h) seeds of any integer dtype -> contiguous int32 holding the
    uint32 bits, as the kernels read them."""
    if tuple(seeds.shape) != tuple(shape):
        raise ValueError(f"seeds must have shape {tuple(shape)}, got {tuple(seeds.shape)}")
    s = seeds.to(torch.int64) & _MASK32
    return torch.where(s >= 2**31, s - 2**32, s).to(torch.int32).contiguous()


def _check_qkv(q, k, v):
    """Raises unless q, k, v suit the kernels: device, dtype, shape, head dim."""
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must be q's {q.dtype}, got {t.dtype}")
        if t.dim() != 4 or t.shape != q.shape:
            raise ValueError(f"{name} must have q's shape (b, n, h, d), got {tuple(t.shape)}")
    check_head_dim(q.shape[-1])


def _check_layout(q, k, v):
    """Raises unless q, k, v as the kernels read them share their strides,
    have a contiguous last dimension and 16-byte aligned rows."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride() != q.stride():
            raise ValueError("q, k and v must have the same strides")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    sb, sn, sh, sd = q.stride()
    align = 16 // q.element_size()  # elements in 16 bytes
    if sd != 1 or sb % align or sn % align or sh % align:
        raise ValueError("q, k, v need a contiguous last dimension and strides that are "
                         f"multiples of {align} elements, got {q.stride()}")


def _pad_heads(t, width: int):
    """(b, n, h, d) -> a contiguous (b, n, h, width), zeros past d."""
    return F.pad(t, (0, width - t.shape[-1]))


def bind(lib):
    """Declare the C interface of a built `csrc/dropout_attention.cu`."""
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.mb_dropout_attention_fwd.argtypes = (
        [ptr] * 3 + [i64] * 3 + [ptr] * 3 + [i32] * 4 + [ctypes.c_uint32, ctypes.c_float, i32, ptr])
    lib.mb_dropout_attention_fwd.restype = i32
    lib.mb_dropout_attention_bwd.argtypes = (
        [ptr] * 3 + [i64] * 3 + [ptr] * 10 + [i32] * 5 + [ctypes.c_uint32, ctypes.c_float, ptr])
    lib.mb_dropout_attention_bwd.restype = i32
    if hasattr(lib, "mb_dropout_attention_plan"):  # sources before it lack it
        lib.mb_dropout_attention_plan.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
        lib.mb_dropout_attention_plan.restype = i32
    return lib


def _lib():
    from maskbit_tpu_torch.nn.cuda_build import load_library

    lib = load_library("dropout_attention")
    if lib.mb_dropout_attention_bwd.argtypes is None:
        bind(lib)
    return lib


def bind_f32(lib):
    """Declare the attention functions of a built `csrc/attention_f32.cu`:
    the forward's arguments are the bf16 one's; the backward's lack dq_acc."""
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.mb_dropout_attention_fwd_f32.argtypes = (
        [ptr] * 3 + [i64] * 3 + [ptr] * 3 + [i32] * 4 + [ctypes.c_uint32, ctypes.c_float, i32, ptr])
    lib.mb_dropout_attention_fwd_f32.restype = i32
    lib.mb_dropout_attention_bwd_f32.argtypes = (
        [ptr] * 3 + [i64] * 3 + [ptr] * 9 + [i32] * 5 + [ctypes.c_uint32, ctypes.c_float, ptr])
    lib.mb_dropout_attention_bwd_f32.restype = i32
    for plan in (lib.mb_attention_fwd_f32_plan, lib.mb_attention_bwd_f32_plan):
        plan.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
        plan.restype = i32
    return lib


def _lib_f32():
    """`csrc/attention_f32.cu`, its attention functions declared (`bind_f32`)."""
    from maskbit_tpu_torch.nn.cuda_build import load_library

    lib = load_library("attention_f32")
    if lib.mb_dropout_attention_bwd_f32.argtypes is None:
        bind_f32(lib)
    return lib


def kernel_plan(d: int) -> dict:
    """The bf16 kernels' plan at head dim `d` (one of `HEAD_DIMS`), as
    built: shared memory and blocks an SM of the forward and the backward,
    the backward's Q and G stages and dQ-part buffers."""
    if d not in HEAD_DIMS:
        raise ValueError(f"no instantiation at head dim {d}")
    plan = (ctypes.c_int * 6)()
    if _lib().mb_dropout_attention_plan(d, plan) != 0:
        raise RuntimeError(f"no kernel plan at head dim {d}")
    keys = ("fwd_smem", "fwd_min_blocks", "bwd_smem", "bwd_blocks", "bwd_qg_stages",
            "bwd_dq_buffers")
    return dict(zip(keys, plan))


def kernel_plan_f32(d: int) -> dict:
    """The float32 kernels' plan at head dim `d` (one of `HEAD_DIMS`), as
    built: the backward's shared memory, blocks an SM, queries a step, Q and
    G stages and dQ-part buffers; the forward's shared memory, consumer
    warpgroups (64 queries each) a block and keys a tile."""
    if d not in HEAD_DIMS:
        raise ValueError(f"no instantiation at head dim {d}")
    lib = _lib_f32()
    bwd, fwd = (ctypes.c_int * 5)(), (ctypes.c_int * 3)()
    if lib.mb_attention_bwd_f32_plan(d, bwd) != 0 or lib.mb_attention_fwd_f32_plan(d, fwd) != 0:
        raise RuntimeError(f"no float32 plan at head dim {d}")
    return {**dict(zip(("smem", "blocks", "queries_a_step", "qg_stages", "dq_buffers"), bwd)),
            **dict(zip(("fwd_smem", "fwd_warpgroups", "fwd_keys_a_tile"), fwd))}


def launch_forward(q, k, v, seeds_i32, rate: float):
    """The forward kernel on CUDA tensors; returns (out, lse). `seeds_i32`
    from `seeds_as_int32`, or None for the dropout-free kernel (then rate
    is ignored and lse is None). A head dim that is not a multiple of 16
    runs zero-padded (the module's docstring)."""
    _check_qkv(q, k, v)
    d = q.shape[-1]
    out, lse = _forward_padded(*_padded(d, q, k, v), seeds_i32, rate, d)
    return out[..., :d], lse


def launch_backward(q, k, v, out, lse, g, seeds_i32, rate: float):
    """The backward kernels on CUDA tensors: (dq, dk, dv) from the
    forward's inputs, `out` and `lse`, and the incoming gradient `g`; a
    head dim that is not a multiple of 16 runs zero-padded."""
    _check_qkv(q, k, v)
    g = g.contiguous()
    if g.dtype != q.dtype or g.shape != out.shape:
        raise TypeError(f"the incoming gradient must be {q.dtype} of shape {tuple(out.shape)}")
    d = q.shape[-1]
    q, k, v, out, g = _padded(d, q, k, v, out, g)
    return tuple(t[..., :d] for t in _backward_padded(q, k, v, out, lse, g, seeds_i32, rate, d))


def _padded(d: int, *ts):
    """ts, each (b, n, h, d), zero-padded per head to `padded_head_dim`
    (unchanged where d is one of `HEAD_DIMS`)."""
    dp = padded_head_dim(d)
    return ts if dp == d else tuple(_pad_heads(t, dp) for t in ts)


def _forward_padded(q, k, v, seeds_i32, rate: float, d: int):
    """`launch_forward`'s launch on checked q, k, v holding head dim `d`
    zero-padded to their width; returns (out at that width, lse)."""
    _check_layout(q, k, v)
    b, n, h, dp = q.shape
    dev = q.device
    dropout = seeds_i32 is not None
    if dropout and (seeds_i32.dtype != torch.int32 or seeds_i32.device != dev
                    or tuple(seeds_i32.shape) != (b, h) or not seeds_i32.is_contiguous()):
        raise ValueError(f"seeds_i32 must be contiguous int32 {(b, h)} on {dev}")
    out = torch.empty((b, n, h, dp), dtype=q.dtype, device=dev)
    lse = torch.empty((b * h, n), dtype=torch.float32, device=dev) if dropout else None
    fn = (_lib_f32().mb_dropout_attention_fwd_f32 if q.dtype is torch.float32
          else _lib().mb_dropout_attention_fwd)
    with torch.cuda.device(dev):  # the runtime launches on the current device
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3],
            _ptr(seeds_i32), out.data_ptr(), _ptr(lse), b, n, h, d,
            keep_threshold(rate), 1.0 / (1.0 - rate), int(dropout),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dropout_attention forward launch failed: CUDA error {err}")
    count("dropout_attention_fwd" if dropout else "fused_attention", d, q.dtype)
    return out, lse


def _backward_padded(q, k, v, out, lse, g, seeds_i32, rate: float, d: int):
    """`launch_backward`'s launches on checked q, k, v, out and a
    contiguous g, each holding head dim `d` zero-padded to their width;
    returns dq, dk, dv at that width."""
    _check_layout(q, k, v)
    if q.dtype is torch.float32:
        grads = backward_f32_with(_lib_f32(), q, k, v, out, lse, g, seeds_i32, rate, d)
    else:
        grads = backward_with(_lib(), q, k, v, out, lse, g, seeds_i32, rate, d)
    count("dropout_attention_bwd", d, q.dtype)
    return grads


def _ptr(t):
    return None if t is None else t.data_ptr()


def backward_with(lib, q, k, v, out, lse, g, seeds_i32, rate: float, d=None):
    """`launch_backward`'s launch through `lib` (a `bind`-declared build of
    the source), on checked inputs with a contiguous `g`, at head dim `d`
    (default: q's; q, k, v, out and g then hold it zero-padded to their
    width); not counted."""
    b, n, h, dp = q.shape
    d = dp if d is None else d
    dev = q.device
    dq, dk, dv = (torch.empty((b, n, h, dp), dtype=torch.bfloat16, device=dev)
                  for _ in range(3))
    tiles = -(-n // TILE)
    # scratch: per query row (lse * log2 e, delta), padded to whole tiles;
    # up to d = 128 the f32 sum of dq over key tiles (b*h*n*d*4 bytes, 33.7
    # MB at (32, 257, 16, 64)) and one ticket per (batch*head, query tile);
    # past 128 the dQ kernel writes dq once and needs neither
    stats = torch.empty((b * h, tiles * TILE, 2), dtype=torch.float32, device=dev)
    narrow = d < WIDE_MIN_HEAD_DIM
    dq_acc = torch.empty((b * h, n, dp), dtype=torch.float32, device=dev) if narrow else None
    tickets = torch.empty((b * h, tiles), dtype=torch.int32, device=dev) if narrow else None
    with torch.cuda.device(dev):
        err = lib.mb_dropout_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3], out.data_ptr(),
            g.data_ptr(), lse.data_ptr(), seeds_i32.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), stats.data_ptr(), _ptr(dq_acc), _ptr(tickets), b, n, h, d,
            int(tiles <= ROTATE_MAX_TILES), keep_threshold(rate), 1.0 / (1.0 - rate),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dropout_attention backward launch failed: CUDA error {err}")
    return dq, dk, dv


def backward_f32_with(lib, q, k, v, out, lse, g, seeds_i32, rate: float, d=None):
    """The float32 backward's launches through `lib` (a `bind_f32`-declared
    build of `csrc/attention_f32.cu`) on checked inputs with a contiguous
    `g`, at head dim `d` (default: q's; the inputs then hold it zero-padded
    to their width); not counted. Up to d = 128 dq is summed over key tiles
    in place, in a fixed order, as the bf16 backward's f32 sum is; past it
    the dQ kernel writes it once."""
    b, n, h, dp = q.shape
    d = dp if d is None else d
    dev = q.device
    dq, dk, dv = (torch.empty((b, n, h, dp), dtype=torch.float32, device=dev) for _ in range(3))
    tiles = -(-n // TILE)
    # scratch: per query row (lse * log2 e, delta), padded to whole tiles;
    # up to d = 128 one ticket per (batch*head, query tile)
    stats = torch.empty((b * h, tiles * TILE, 2), dtype=torch.float32, device=dev)
    tickets = (torch.empty((b * h, tiles), dtype=torch.int32, device=dev)
               if d < WIDE_MIN_HEAD_DIM else None)
    with torch.cuda.device(dev):
        err = lib.mb_dropout_attention_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3], out.data_ptr(),
            g.data_ptr(), lse.data_ptr(), seeds_i32.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), stats.data_ptr(), _ptr(tickets), b, n, h, d,
            int(tiles <= ROTATE_MAX_TILES), keep_threshold(rate), 1.0 / (1.0 - rate),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dropout_attention float32 backward launch failed: CUDA error {err}")
    return dq, dk, dv


class _DropoutAttention(torch.autograd.Function):
    # on the card the padded q, k, v and out are saved (a head dim that is
    # not a multiple of 16), so the backward pads only the incoming gradient
    @staticmethod
    def forward(ctx, q, k, v, seeds, rate):
        ctx.rate = rate
        if q.device.type == "cuda":
            _check_qkv(q, k, v)
            d = ctx.d = q.shape[-1]
            seeds_i32 = seeds_as_int32(seeds.to(q.device), (q.shape[0], q.shape[2]))
            q, k, v = _padded(d, q, k, v)
            out, lse = _forward_padded(q, k, v, seeds_i32, rate, d)
            ctx.save_for_backward(q, k, v, out, lse, seeds_i32)
            return out if out.shape[-1] == d else out[..., :d]
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, seeds)
            return dropout_attention_reference(q, k, v, seeds, rate)
        raise ValueError(f"dropout_attention: no kernel for device {q.device}")

    @staticmethod
    def backward(ctx, g):
        if g.device.type == "cuda":
            q, k, v, out, lse, seeds = ctx.saved_tensors
            d = ctx.d
            g, = _padded(d, g.contiguous())
            grads = _backward_padded(q, k, v, out, lse, g, seeds, ctx.rate, d)
            dq, dk, dv = (t[..., :d] for t in grads)
        else:
            q, k, v, seeds = ctx.saved_tensors
            dq, dk, dv = dropout_attention_backward_reference(q, k, v, g, seeds, ctx.rate)
        return dq, dk, dv, None, None


def dropout_attention(q, k, v, seeds, rate: float) -> torch.Tensor:
    """(b, n, h, d) attention with in-kernel attention-prob dropout,
    differentiable in q, k, v. `seeds` (b, h): uint32 values in any integer
    dtype (int32 holds their bits)."""
    rate = _check_rate(rate)
    b, _, h, _ = q.shape
    if tuple(seeds.shape) != (b, h):
        raise ValueError(f"seeds must be (batch, heads) = {(b, h)}, got {tuple(seeds.shape)}")
    return _DropoutAttention.apply(q, k, v, seeds, rate)


def fused_attention(q, k, v) -> torch.Tensor:
    """(b, n, h, d) dropout-free attention, forward only (as the TPU
    kernel): the dropout forward kernel with the mask compiled out."""
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v)
    if q.device.type == "cuda":
        return launch_forward(q, k, v, None, 0.0)[0]
    raise ValueError(f"fused_attention: no kernel for device {q.device}")
