"""The dropout-attention backward built from several sources, side by side on one card.

    python -m maskbit_tpu_torch.cli.compare_backward OLD.cu NEW.cu [MORE.cu ...]
    python -m maskbit_tpu_torch.cli.compare_backward --tree smoke_parent --tree . \\
        --head-dims 16,32,48,64,80,96,112,128
    python -m maskbit_tpu_torch.cli.compare_backward --tree smoke_parent --tree . \\
        --head-dims 192,256 --forward
    python -m maskbit_tpu_torch.cli.compare_backward --dtype float32 --tree smoke_parent \\
        --tree . --head-dims 192,256 --forward

(from the checkout's root: it times with `chip_smoke._device_ms`).

Each source is a version of `maskbit_tpu_torch/csrc/dropout_attention.cu`
(with `--dtype float32`, of `maskbit_tpu_torch/csrc/attention_f32.cu`, on
float32 inputs within phase 17's `F32_TOL`) with the same C interface, e.g.
one taken from another commit with `git show
<commit>:maskbit_tpu_torch/csrc/dropout_attention.cu`, or a whole tree's
(`--tree DIR` takes DIR/maskbit_tpu_torch/csrc/dropout_attention.cu or
attention_f32.cu, whose headers then come from DIR too: a source's own
directory is searched first). Sources from before the backward took the
head dim (`int d`) have another interface, which the binding would
misread: they are refused before the build. Every source is built with
the package's nvcc flags (all at once, into the git-ignored
`build/compare_backward/`), and
its ptxas lines on registers, spills and serialised wgmma are printed.
Then, at each head dim of `--head-dims` (default 64), on the forward of this
checkout's kernel:
  * dq, dk and dv of every source are bit-identical to a repeated call of
    their own and agree with the plain version (the dtype's tolerance), at
    ragged lengths and in both dq orders (the wrapper's order and key-tile
    order); whether they are bit-identical to the first source's is
    printed (two designs may sum in other orders);
  * each source's backward is timed by device time (the summed device
    times of its kernels under torch.profiler over 50 calls, per call) at
    the training shapes, (32, 257, 16, 64) and (8, 1025, 16, 64) at d = 64
    and `chip_smoke.HEAD_DIM_SHAPES`' dropout shape at n = 257 at the
    others, the sources taken in turn and then in reverse, so drift of the
    card's clock shows;
  * with `--forward`, each source's forward, with dropout and without (the
    kernel of `fused_attention`), is checked against the plain version
    (the dtype's tolerance) and bit for bit on a repeat, and timed the same
    way, at the dropout shape and
    at `chip_smoke.HEAD_DIM_SHAPES`' fused_attention shape.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch

from maskbit_tpu_torch.nn import cuda_build
from maskbit_tpu_torch.nn import dropout_attention as da

RATE = 0.1
CHECK_SHAPES = ((2, 1, 3), (2, 17, 3), (2, 65, 3), (2, 129, 3), (4, 257, 16), (2, 1025, 8))
TIME_SHAPES_64 = ((32, 257, 16), (8, 1025, 16))


# per dtype: the source's name, its backward's C function, the binding, the
# backward through a bound library (both `backward_with`'s arguments)
DTYPES = {"bf16": ("dropout_attention.cu", "mb_dropout_attention_bwd", da.bind, da.backward_with),
          "float32": ("attention_f32.cu", "mb_dropout_attention_bwd_f32", da.bind_f32,
                      da.backward_f32_with)}


def build(sources, dtype="bf16"):
    import chip_smoke

    _, fn, bind, _ = DTYPES[dtype]
    for src in sources:
        with open(src) as f:
            if not re.search(fn + r"\([^)]*\bint d\b", f.read()):
                raise ValueError(f"{src}: its {fn} takes no head dim d, so its interface is not "
                                 "this checkout's")
    out_dir = cuda_build.BUILD_DIR.parent / "compare_backward"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen(cuda_build.nvcc_command(src, out_dir / f"lib{i}.so"),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i, src in enumerate(sources)]
    libs = []
    for i, (src, proc) in enumerate(zip(sources, procs)):
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{err}")
        print(f"== {src}")
        for line in err.splitlines():
            if "wgmma" in line:  # a serialised wgmma, with its reason
                print(line.strip())
        for k in chip_smoke.ptxas_kernels(err):
            print(f"{k['kernel']}: {k['registers']} registers, spill stores {k['spill_stores']} "
                  f"B, spill loads {k['spill_loads']} B")
        libs.append(bind(ctypes.CDLL(str(out_dir / f"lib{i}.so"))))
    return libs


def inputs(b, n, h, d=64, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(n)
    q, k, v = torch.randn(b, n, 3, h, d, generator=g, device="cuda").to(dtype).unbind(2)
    seeds = torch.randint(0, 2**32, (b, h), generator=g, device="cuda", dtype=torch.int64)
    seeds32 = da.seeds_as_int32(seeds, (b, h))
    grad = torch.randn(b, n, h, d, generator=g, device="cuda").to(dtype)
    out, lse = da.launch_forward(q, k, v, seeds32, RATE)
    return q, k, v, out, lse, grad, seeds32, seeds


def forward_with(lib, q, k, v, seeds32, rate=RATE):
    """The forward of `lib` on q, k, v at their head dim, in their dtype;
    seeds32 None for the dropout-free kernel. Returns out."""
    b, n, h, d = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b * h, n), dtype=torch.float32, device=q.device) if seeds32 is not None \
        else None
    fwd = lib.mb_dropout_attention_fwd_f32 if q.dtype is torch.float32 else \
        lib.mb_dropout_attention_fwd
    err = fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3],
        None if seeds32 is None else seeds32.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, n, h, d, da.keep_threshold(rate),
        1.0 / (1.0 - rate), int(seeds32 is not None), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"forward launch failed: CUDA error {err}")
    return out


def _tol(dtype, refs):
    """The agreement a backward or forward must reach: phase 3's tolerance
    in bf16, phase 17's `F32_TOL` in float32, each times the largest
    reference value where that exceeds 1."""
    import chip_smoke

    atol = chip_smoke.F32_TOL if dtype is torch.float32 else chip_smoke.DROPOUT_ATOL
    return atol * max(1.0, max(r.abs().max().item() for r in refs))


def compare_forward(sources, libs, d, dtype=torch.bfloat16):
    """--forward at head dim d: each source's forward with and without
    dropout against the plain version and bit for bit on a repeat, then
    timed in turn and in reverse."""
    import chip_smoke

    h, b, bb, _ = chip_smoke.HEAD_DIM_SHAPES[d]
    for label, (bs, drop) in (("dropout forward", (b, True)), ("fused_attention", (bb, False))):
        q, k, v, _, _, _, seeds32, seeds = inputs(bs, 257, h, d, dtype)
        s32 = seeds32 if drop else None
        want = (da.dropout_attention_reference(q.float(), k.float(), v.float(), seeds, RATE)
                if drop else da.fused_attention_reference(q.float(), k.float(), v.float()))
        tol = _tol(dtype, [want])
        for src, lib in zip(sources, libs):
            got = forward_with(lib, q, k, v, s32)
            err = (got.float() - want).abs().max().item()
            repeat = torch.equal(got, forward_with(lib, q, k, v, s32))
            if err > tol or not repeat:
                raise AssertionError(f"{src} {label} at ({bs}, 257, {h}, {d}): max |error| {err} "
                                     f"(tol {tol}), repeat bit-identical {repeat}")
        times = {src: [] for src in sources}
        for src, lib in [*zip(sources, libs), *reversed(list(zip(sources, libs)))]:
            times[src].append(chip_smoke._device_ms(torch, lambda: forward_with(lib, q, k, v, s32)))
        print(f"({bs}, 257, {h}, {d}) {label} device ms: "
              + "; ".join(f"{src} {', '.join(f'{t:.4f}' for t in ts)}"
                          for src, ts in times.items()))


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("sources", nargs="*",
                   help="versions of csrc/dropout_attention.cu (or attention_f32.cu)")
    p.add_argument("--tree", action="append", default=[],
                   help="a checkout whose csrc/dropout_attention.cu (or attention_f32.cu) to "
                        "take (before the positional sources; repeatable)")
    p.add_argument("--dtype", choices=tuple(DTYPES), default="bf16",
                   help="bf16 (csrc/dropout_attention.cu) or float32 (csrc/attention_f32.cu) "
                        "(default %(default)s)")
    p.add_argument("--head-dims", default="64",
                   help="comma-separated head dims to check and time (default %(default)s)")
    p.add_argument("--forward", action="store_true",
                   help="also check and time the forward, with dropout and without")
    args = p.parse_args(argv)
    args.sources = [os.path.join(t, "maskbit_tpu_torch", "csrc", DTYPES[args.dtype][0])
                    for t in args.tree] + args.sources
    args.head_dims = [int(x) for x in args.head_dims.split(",") if x]
    return args


def main(argv=None) -> int:
    import chip_smoke

    args = _args(sys.argv[1:] if argv is None else argv)
    sources = [os.path.abspath(s) for s in args.sources]
    if len(sources) < 2 or not torch.cuda.is_available():
        print(__doc__)
        return 2
    libs = build(sources, args.dtype)
    backward = DTYPES[args.dtype][3]
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    rotate_max = da.ROTATE_MAX_TILES
    for d in args.head_dims:
        for b, n, h in CHECK_SHAPES:
            x = inputs(b, n, h, d, dtype)
            qf, kf, vf = (t.float() for t in x[:3])
            refs = da.dropout_attention_backward_reference(qf, kf, vf, x[5].float(), x[7], RATE)
            tol = _tol(dtype, refs)
            for order, max_tiles in (("wrapper", rotate_max), ("key tile", 0)):
                da.ROTATE_MAX_TILES = max_tiles
                first = backward(libs[0], *x[:7], RATE)
                for src, lib in zip(sources, libs):
                    got, again = (backward(lib, *x[:7], RATE), backward(lib, *x[:7], RATE))
                    err = max((a.float() - r).abs().max().item() for a, r in zip(got, refs))
                    repeat = all(torch.equal(a, c) for a, c in zip(got, again))
                    if not repeat or err > tol:
                        raise AssertionError(
                            f"{src} at ({b}, {n}, {h}, {d}), {order} order: repeat bit-identical "
                            f"{repeat}, max |error| against the plain version {err} (tol {tol})")
                    diff = max((a.float() - c.float()).abs().max().item()
                               for a, c in zip(first, got))
                    print(f"({b}, {n}, {h}, {d}) {order} order, {src}: max |error| {err:.5f} "
                          f"(tol {tol:.4f}), repeats bit-identical, max |diff| from the first "
                          f"source {diff:.6f}" + (" (bit-identical)" if diff == 0 else ""))
            da.ROTATE_MAX_TILES = rotate_max
        shapes = TIME_SHAPES_64 if d == 64 else (
            (chip_smoke.HEAD_DIM_SHAPES[d][1], 257, chip_smoke.HEAD_DIM_SHAPES[d][0]),)
        for b, n, h in shapes:
            x = inputs(b, n, h, d, dtype)[:7]
            times = {src: [] for src in sources}
            for src, lib in [*zip(sources, libs), *reversed(list(zip(sources, libs)))]:
                times[src].append(chip_smoke._device_ms(
                    torch, lambda: backward(lib, *x, RATE)))
            print(f"({b}, {n}, {h}, {d}) backward device ms: "
                  + "; ".join(f"{src} {', '.join(f'{t:.4f}' for t in ts)}"
                              for src, ts in times.items()))
        if args.forward:
            compare_forward(sources, libs, d, dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
