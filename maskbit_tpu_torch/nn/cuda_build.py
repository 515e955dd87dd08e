"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled at first use with `nvcc` into a shared
library with a plain C interface and loaded with `ctypes`. The library is
named after a hash of its source and of every header under `csrc/` that it
includes (`#include "..."`, followed through headers), so an edited source
or header rebuilds and an unchanged one loads from the build directory,
`build/maskbit_tpu_torch/` under the checkout (git-ignored). `build_all`
compiles every source at once without loading it: a process that spawns
workers (the split sampler's) builds there first, so each worker only loads
the libraries. Concurrent builds of one library, in threads or processes,
are safe (a per-process temporary file, then `os.replace`), but redundant.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "maskbit_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)

_locks_guard = threading.Lock()
_locks: dict[str, threading.Lock] = {}  # one per library: different ones build in parallel
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, dict] = {}  # name -> {"seconds", "cached", "ptxas"}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def source_digest(src: Path, include_dir: Path = CSRC) -> str:
    """Hash of `src` and of the files it includes from its own directory or
    `include_dir` (quoted includes, followed through the included files);
    system headers (`<...>`) are not followed."""
    h = hashlib.sha256()
    seen: set[Path] = set()
    todo = [Path(src).resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        data = path.read_bytes()
        h.update(path.name.encode() + b"\0" + data + b"\0")
        for inc in _INCLUDE.findall(data.decode(errors="replace")):
            for base in (path.parent, Path(include_dir)):
                if (base / inc).is_file():
                    todo.append((base / inc).resolve())
                    break
    return h.hexdigest()[:16]


def nvcc_command(src, out) -> list[str]:
    """nvcc building `src` into the shared library `out`, headers from csrc/."""
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)]


def sources() -> list[str]:
    """The names of the kernel sources, `csrc/<name>.cu`."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _build(name: str) -> tuple[Path, bool, str]:
    """(library path, whether it was built already, ptxas output)."""
    src = CSRC / f"{name}.cu"
    digest = source_digest(src)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib_path.exists():
        return lib_path, True, ""
    tmp = BUILD_DIR / f".lib{name}-{digest}.{os.getpid()}.{threading.get_ident()}.so"
    proc = subprocess.run(nvcc_command(src, tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {src.name} ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path, False, proc.stderr


def build_all() -> None:
    """Compile every source that is not built yet, one nvcc each, all at
    once, without loading them; raises the first failure."""
    errors = []

    def one(name):
        try:
            _build(name)
        except Exception as e:  # noqa: BLE001 — raised below, on the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=one, args=(n,)) for n in sources()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def load_library(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load `csrc/<name>.cu`. Raises on failure."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        t0 = time.perf_counter()
        lib_path, cached, ptxas = _build(name)
        lib = ctypes.CDLL(str(lib_path))
        build_log[name] = {"seconds": time.perf_counter() - t0, "cached": cached,
                           "ptxas": ptxas}
        _libs[name] = lib
        return lib
