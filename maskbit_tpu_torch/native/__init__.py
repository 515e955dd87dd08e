"""Native (C++/libjpeg) JPEG decoder of the data pipeline.

Counterpart of `maskbit_tpu/native/__init__.py`, with its own copy of
`decode.cc`: `decode_crop_resize` runs bytes -> cropped, resized uint8 HWC
in one C++ pass (DCT-domain scaled decode for large sources) and releases
the GIL, so the thread pool of `data/tar_reader.py` scales over cores.

The library is compiled at first use with `g++ -O3 -march=native -shared
-fPIC ... -ljpeg` and named after a hash of the source, in
`build/maskbit_tpu_torch/` under the checkout (git-ignored), as
`nn/cuda_build` names the CUDA libraries; when that directory cannot be
written, under `utils.paths.user_cache_dir()`. A build goes to a
per-process temporary file and is renamed into place, so concurrent
processes never load a half-written library. `is_available()` and
`build_error()` say whether it built; `decode_backend="native"` raises when
it did not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from maskbit_tpu_torch.utils.paths import user_cache_dir

SRC = Path(__file__).resolve().parent / "decode.cc"
BUILD_DIR = SRC.parent.parent.parent / "build" / "maskbit_tpu_torch"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def lib_path(build_dir: Path = BUILD_DIR) -> Path:
    """The library's path in `build_dir`: named after the source's hash, so
    an edited source builds anew."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return Path(build_dir) / f"libmaskbit_decode-{digest}.so"


def _build_dir() -> Path:
    """The checkout's build directory, or the user cache when it cannot be
    written."""
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        if os.access(BUILD_DIR, os.W_OK):
            return BUILD_DIR
    except OSError:
        pass
    return Path(user_cache_dir())


def _build(path: Path) -> Optional[str]:
    """Compile decode.cc into `path`; an error message, or None."""
    tmp = path.with_name(f".{path.name}.{os.getpid()}.{threading.get_ident()}")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-ljpeg", "-o", str(tmp)]
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            return proc.stderr[-2000:] or f"g++ exited {proc.returncode}"
        os.replace(tmp, path)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{type(e).__name__}: {e}"
    finally:
        if tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        path = lib_path(_build_dir())
        if not path.exists():
            err = _build(path)
            if err is not None:
                _build_error = err
                return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _build_error = str(e)
            return None
        lib.mb_decode_info.restype = ctypes.c_int
        lib.mb_decode_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.mb_decode_crop_resize.restype = ctypes.c_int
        lib.mb_decode_crop_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        _lib = lib
        return _lib


def is_available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def decode_info(buf: bytes) -> Tuple[int, int]:
    """(width, height) from the JPEG header only."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decode unavailable: {_build_error}")
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.mb_decode_info(buf, len(buf), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"not a decodable JPEG (rc={rc})")
    return w.value, h.value


FILTERS = {"bilinear": 0, "bicubic": 1}


def decode_crop_resize(buf: bytes, top: float, left: float, crop_h: float, crop_w: float,
                       out_h: int, out_w: int, flip: bool = False,
                       interpolation: str = "bilinear") -> np.ndarray:
    """JPEG bytes -> (out_h, out_w, 3) uint8: decode (DCT-scaled when the
    crop oversamples the output), crop the full-resolution box, resize with
    `interpolation` (bilinear, or bicubic with Keys a = -0.5: the two
    filters the configs use), flip horizontally if asked. Releases the
    GIL."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decode unavailable: {_build_error}")
    if interpolation not in FILTERS:
        raise ValueError(f"unsupported native interpolation {interpolation!r}")
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.mb_decode_crop_resize(
        buf, len(buf), float(top), float(left), float(crop_h), float(crop_w),
        int(out_h), int(out_w), int(bool(flip)), FILTERS[interpolation],
        out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"JPEG decode failed (rc={rc})")
    return out
