"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled at first use with `nvcc` into a shared
library with a plain C interface and loaded with `ctypes`. The library is
named after a hash of its source, so an edited source rebuilds and an
unchanged one loads from the build directory, `build/maskbit_tpu_torch/`
under the checkout (git-ignored).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "maskbit_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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


def load_library(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load `csrc/<name>.cu`. Raises on failure."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
        t0 = time.perf_counter()
        ptxas = ""
        cached = lib_path.exists()
        if not cached:
            tmp = BUILD_DIR / f".lib{name}-{digest}.{os.getpid()}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src.name} ({proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            ptxas = proc.stderr
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        build_log[name] = {"seconds": time.perf_counter() - t0, "cached": cached,
                           "ptxas": ptxas}
        _libs[name] = lib
        return lib
