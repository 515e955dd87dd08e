"""The dropout-attention backward built from several sources, side by side on one card.

    python -m maskbit_tpu_torch.cli.compare_backward OLD.cu NEW.cu [MORE.cu ...]

(from the checkout's root: it times with `chip_smoke._device_ms`).

Each source is a version of `maskbit_tpu_torch/csrc/dropout_attention.cu`
with the same C interface, e.g. one taken from another commit with `git show
<commit>:maskbit_tpu_torch/csrc/dropout_attention.cu`. Sources from before
`mb_dropout_attention_bwd` took the head dim (`int d`) have another
interface, which the binding would misread: they are refused before the
build. Every source is built
with the package's nvcc flags (all at once, into the git-ignored
`build/compare_backward/`), and its ptxas lines on registers, spills and
serialised wgmma are printed. Then, on the forward of this checkout's
kernel:
  * dq, dk and dv of every source are bit-identical to the first source's
    and to a repeated call of their own, at ragged lengths and in both dq
    orders (the wrapper's order and key-tile order);
  * each source's backward is timed by device time (the summed device
    times of its kernels under torch.profiler over 50 calls, per call) at
    the training shapes (32, 257, 16, 64) and (8, 1025, 16, 64), the sources
    taken in turn and then in reverse, so drift of the card's clock shows.
"""

from __future__ import annotations

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
TIME_SHAPES = ((32, 257, 16), (8, 1025, 16))


def build(sources):
    for src in sources:
        with open(src) as f:
            if not re.search(r"mb_dropout_attention_bwd\([^)]*\bint d\b", f.read()):
                raise ValueError(f"{src}: its mb_dropout_attention_bwd takes no head dim d, so "
                                 "its interface is not this checkout's")
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
            if any(w in line for w in ("entry function", "registers", "spill", "wgmma")):
                print(line.strip())
        libs.append(da.bind(ctypes.CDLL(str(out_dir / f"lib{i}.so"))))
    return libs


def inputs(b, n, h):
    g = torch.Generator(device="cuda").manual_seed(n)
    q, k, v = torch.randn(b, n, 3, h, 64, generator=g, device="cuda").bfloat16().unbind(2)
    seeds = torch.randint(0, 2**32, (b, h), generator=g, device="cuda", dtype=torch.int64)
    seeds32 = da.seeds_as_int32(seeds, (b, h))
    grad = torch.randn(b, n, h, 64, generator=g, device="cuda").bfloat16()
    out, lse = da.launch_forward(q, k, v, seeds32, RATE)
    return q, k, v, out, lse, grad, seeds32


def main(argv=None) -> int:
    import chip_smoke

    sources = sys.argv[1:] if argv is None else argv
    if len(sources) < 2 or not torch.cuda.is_available():
        print(__doc__)
        return 2
    libs = build([os.path.abspath(s) for s in sources])
    rotate_max = da.ROTATE_MAX_TILES
    for b, n, h in CHECK_SHAPES:
        x = inputs(b, n, h)
        for order, max_tiles in (("wrapper", rotate_max), ("key tile", 0)):
            da.ROTATE_MAX_TILES = max_tiles
            first = da.backward_with(libs[0], *x, RATE)
            for src, lib in zip(sources, libs):
                got, again = da.backward_with(lib, *x, RATE), da.backward_with(lib, *x, RATE)
                same = all(torch.equal(a, c) for a, c in zip(first, got))
                repeat = all(torch.equal(a, c) for a, c in zip(got, again))
                if not (same and repeat):
                    raise AssertionError(f"{src} at ({b}, {n}, {h}), {order} order: equal to the "
                                         f"first source {same}, to itself {repeat}")
        da.ROTATE_MAX_TILES = rotate_max
        print(f"({b}, {n}, {h}): dq, dk, dv bit-identical across sources and repeats")
    for b, n, h in TIME_SHAPES:
        x = inputs(b, n, h)
        times = {src: [] for src in sources}
        for src, lib in [*zip(sources, libs), *reversed(list(zip(sources, libs)))]:
            times[src].append(chip_smoke._device_ms(torch, lambda: da.backward_with(lib, *x, RATE)))
        print(f"({b}, {n}, {h}, 64) backward device ms: "
              + "; ".join(f"{src} {', '.join(f'{t:.4f}' for t in ts)}" for src, ts in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
