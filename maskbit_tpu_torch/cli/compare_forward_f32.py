"""The float32 attention forward built from several sources, side by side on one card.

    python -m maskbit_tpu_torch.cli.compare_forward_f32 OLD.cu NEW.cu [MORE.cu ...]
    python -m maskbit_tpu_torch.cli.compare_forward_f32 --tree smoke_parent --tree . \\
        --head-dims 32,64,128

(from the checkout's root: it times with `chip_smoke._device_ms`).

Each source is a version of `maskbit_tpu_torch/csrc/attention_f32.cu` with
the same `mb_dropout_attention_fwd_f32` (e.g. `git show
<commit>:maskbit_tpu_torch/csrc/attention_f32.cu`, or a copy with another
tuning), or a whole tree's (`--tree DIR` takes
DIR/maskbit_tpu_torch/csrc/attention_f32.cu, whose headers then come from
DIR too: a source's own directory is searched first). Every source is
built with the package's nvcc flags (all at once, into the git-ignored
`build/compare_forward_f32/`), and its ptxas lines on registers, spills
and serialised wgmma are printed for the forward kernels. Then, at each
head dim of `--head-dims` (default 64):
  * out (with and without dropout) of every source is bit-identical to a
    repeated call of its own and within phase 17's `F32_TOL` of the plain
    version in float32 (TF32 off), at ragged lengths on strided views of
    one qkv buffer;
  * each source's forward is timed by device time (the summed device times
    of its kernels under torch.profiler over 50 calls, per call) at phase
    17's shapes: `fused_attention` at the block's, the dropout forward at
    the training batch's, the sources taken in turn and then in reverse, so
    drift of the card's clock shows.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

from maskbit_tpu_torch.nn import cuda_build
from maskbit_tpu_torch.nn import dropout_attention as da

RATE = 0.1
CHECK_SHAPES = ((2, 1, 3), (2, 17, 3), (2, 65, 3), (2, 257, 3), (1, 1025, 2))


def build(sources):
    import chip_smoke

    out_dir = cuda_build.BUILD_DIR.parent / "compare_forward_f32"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen(cuda_build.nvcc_command(src, out_dir / f"lib{i}.so"),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i, src in enumerate(sources)]
    fns = []
    for i, (src, proc) in enumerate(zip(sources, procs)):
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{err}")
        print(f"== {src}")
        for line in err.splitlines():
            if "wgmma" in line and "attn_fwd" in line:  # a serialised wgmma, with its reason
                print(line.strip())
        for k in chip_smoke.ptxas_kernels(err):
            if "attn_fwd" in k["kernel"]:
                print(f"{k['kernel']}: {k['registers']} registers, spill stores "
                      f"{k['spill_stores']} B, spill loads {k['spill_loads']} B")
        fn = ctypes.CDLL(str(out_dir / f"lib{i}.so")).mb_dropout_attention_fwd_f32
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([ptr] * 3 + [i64] * 3 + [ptr] * 3 + [i32] * 4
                       + [ctypes.c_uint32, ctypes.c_float, i32, ptr])
        fn.restype = i32
        fns.append(fn)
    return fns


def forward_with(fn, q, k, v, seeds32):
    """One forward through `fn` (a source's mb_dropout_attention_fwd_f32):
    with dropout where seeds32 is given; returns out (and lse)."""
    b, n, h, d = q.shape
    out = torch.empty(b, n, h, d, device=q.device)
    lse = None if seeds32 is None else torch.empty(b * h, n, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3],
             None if seeds32 is None else seeds32.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), b, n, h, d, da.keep_threshold(RATE),
             1.0 / (1.0 - RATE), int(seeds32 is not None), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"forward launch failed: CUDA error {err}")
    return out if lse is None else (out, lse)


def inputs(b, n, h, d):
    g = torch.Generator(device="cuda").manual_seed(n * d)
    q, k, v = torch.randn(b, n, 3, h, d, generator=g, device="cuda").unbind(2)
    seeds = torch.randint(0, 2**32, (b, h), generator=g, device="cuda", dtype=torch.int64)
    return q, k, v, seeds, da.seeds_as_int32(seeds, (b, h))


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("sources", nargs="*", help="versions of csrc/attention_f32.cu")
    p.add_argument("--tree", action="append", default=[],
                   help="a checkout whose csrc/attention_f32.cu to take (before the positional "
                        "sources; repeatable)")
    p.add_argument("--head-dims", default="64",
                   help="comma-separated head dims (multiples of 16) to check and time "
                        "(default %(default)s)")
    args = p.parse_args(argv)
    args.sources = [os.path.join(t, "maskbit_tpu_torch", "csrc", "attention_f32.cu")
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
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build(sources)
    for d in args.head_dims:
        for b, n, h in CHECK_SHAPES:
            q, k, v, seeds, seeds32 = inputs(b, n, h, d)
            refs = (da.fused_attention_reference(q, k, v),
                    da.dropout_attention_reference(q, k, v, seeds, RATE))
            for src, fn in zip(sources, fns):
                for s32, ref in zip((None, seeds32), refs):
                    got, again = (forward_with(fn, q, k, v, s32), forward_with(fn, q, k, v, s32))
                    got, again = (x if s32 is None else x[0] for x in (got, again))
                    err = (got - ref).abs().max().item()
                    tol = chip_smoke.F32_TOL * max(1.0, ref.abs().max().item())
                    if not torch.equal(got, again) or err > tol:
                        raise AssertionError(
                            f"{src} at ({b}, {n}, {h}, {d}), dropout {s32 is not None}: repeat "
                            f"bit-identical {torch.equal(got, again)}, max |error| {err} (tol "
                            f"{tol})")
                print(f"({b}, {n}, {h}, {d}) {src}: within F32_TOL of the plain version with "
                      "and without dropout, repeats bit-identical")
        heads, train_b, block_b, _ = chip_smoke._f32_shapes(d)
        for b, s32_on in ((block_b, False), (train_b, True)):
            q, k, v, _, seeds32 = inputs(b, 257, heads, d)
            s32 = seeds32 if s32_on else None
            times = {src: [] for src in sources}
            for src, fn in [*zip(sources, fns), *reversed(list(zip(sources, fns)))]:
                times[src].append(chip_smoke._device_ms(
                    torch, lambda: forward_with(fn, q, k, v, s32)))
            print(f"({b}, 257, {heads}, {d}) {'dropout forward' if s32_on else 'fused_attention'} "
                  "device ms: " + "; ".join(f"{src} {', '.join(f'{t:.4f}' for t in ts)}"
                                            for src, ts in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
