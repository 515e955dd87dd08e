"""The machine code of two trees' kernels, kernel by kernel.

    python -m maskbit_tpu_torch.cli.compare_sass --tree smoke_parent --tree .

Builds every `maskbit_tpu_torch/csrc/*.cu` of each tree with the package's
nvcc flags (all at once, into the git-ignored `build/compare_sass/`),
disassembles each library with `cuobjdump -sass` and compares, library by
library, the SASS of every kernel the first tree has with the second
tree's kernel of the same name: identical, differing, or missing, and the
second tree's kernels the first lacks. Kernel names are compared without
the per-file hash nvcc puts in anonymous namespaces (`_GLOBAL__N__<hash>_`),
which changes with any edit of a file, and code without the listing's
column padding (cuobjdump pads every line of a library to its longest
instruction, so a kernel added to a library moves its neighbours'
columns). It shows that a change left the kernels it did not mean to
touch as they were, bit for bit. Needs nvcc and
cuobjdump (the card's machine), not a card. Exits 1 if a kernel of the
first tree differs or is missing, else 0.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from maskbit_tpu_torch.nn import cuda_build

_FUNCTION = re.compile(r"^\s*Function : (\S+)\s*$", re.MULTILINE)
_NAMESPACE = re.compile(r"_GLOBAL__N__[0-9a-f]+_")


def kernels(sass: str) -> dict:
    """`cuobjdump -sass` output -> {kernel name without the anonymous
    namespace's hash: digest of its code, the hash taken out likewise and
    each run of blanks read as one space}."""
    parts = _FUNCTION.split(sass)

    def code(text):
        return "\n".join(" ".join(line.split())
                         for line in _NAMESPACE.sub("_GLOBAL__N__", text).splitlines())

    return {_NAMESPACE.sub("_GLOBAL__N__", parts[i]):
            hashlib.sha256(code(parts[i + 1]).encode()).hexdigest()
            for i in range(1, len(parts) - 1, 2)}


def compare(first: dict, second: dict) -> dict:
    """The kernels of `first` identical in, differing from or missing from
    `second`, and those only `second` has."""
    return {"identical": sorted(k for k in first if second.get(k) == first[k]),
            "differ": sorted(k for k in first if k in second and second[k] != first[k]),
            "missing": sorted(k for k in first if k not in second),
            "new": sorted(k for k in second if k not in first)}


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    return found or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                                 "cuobjdump")


def _sass(tree: str, tag: str, name: str) -> str:
    src = os.path.join(tree, "maskbit_tpu_torch", "csrc", f"{name}.cu")
    out_dir = cuda_build.BUILD_DIR.parent / "compare_sass" / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{name}.so"
    # the tree's own headers: nvcc searches the source's directory first
    proc = subprocess.run(cuda_build.nvcc_command(src, lib), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    return subprocess.run([_cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout


def _args(argv):
    p = argparse.ArgumentParser(description="Two trees' kernels' SASS, kernel by kernel.")
    p.add_argument("--tree", action="append", default=[],
                   help="a checkout whose csrc/ to build; give it twice (first, then second)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(sys.argv[1:] if argv is None else argv)
    if len(args.tree) != 2:
        print("compare_sass takes two trees: --tree FIRST --tree SECOND")
        return 2
    names = sorted({f[:-3] for tree in args.tree
                    for f in os.listdir(os.path.join(tree, "maskbit_tpu_torch", "csrc"))
                    if f.endswith(".cu")})
    jobs = [(tree, str(i), name) for i, tree in enumerate(args.tree) for name in names
            if os.path.exists(os.path.join(tree, "maskbit_tpu_torch", "csrc", f"{name}.cu"))]
    with ThreadPoolExecutor(len(jobs)) as ex:
        sass = dict(zip(((tag, name) for _, tag, name in jobs), ex.map(lambda j: _sass(*j), jobs)))
    bad = False
    for name in names:
        got = compare(kernels(sass.get(("0", name), "")), kernels(sass.get(("1", name), "")))
        bad |= bool(got["differ"] or got["missing"])
        print(f"[sass] {name}: {len(got['identical'])} identical, {len(got['differ'])} differ "
              f"{got['differ']}, {len(got['missing'])} missing {got['missing']}, "
              f"{len(got['new'])} new {got['new']}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
