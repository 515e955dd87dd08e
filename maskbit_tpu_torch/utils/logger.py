"""Console and file logger, gated to the main process.

Counterpart of `maskbit_tpu/utils/logger.py`: a colored console handler
(on stdout here; the JAX package writes to stderr), an optional file
handler, and per-process gating: with `main_process_only` (the default)
only rank 0's handlers emit. The gate is read when a record is emitted,
not when the logger is set up, so a logger made before the process group
is joined gates correctly afterwards. Records still propagate to the root
logger. A remote `scheme://` log path streams through fsspec with a 1 MB
buffer, flushed at most once a minute (`_RateLimitedFlushHandler`), so a
run logging to object storage does not issue one request per line.
"""

from __future__ import annotations

import atexit
import functools
import logging
import os
import sys
import time
from typing import Optional

from maskbit_tpu_torch.parallel.mesh import is_main_process

_COLORS = {
    logging.DEBUG: "\x1b[36m",      # cyan
    logging.INFO: "\x1b[32m",       # green
    logging.WARNING: "\x1b[33m",    # yellow
    logging.ERROR: "\x1b[31m",      # red
    logging.CRITICAL: "\x1b[41m",   # red background
}
_RESET = "\x1b[0m"
_FORMAT = "%(asctime)s %(levelname)s %(message)s"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        color = _COLORS.get(record.levelno, "")
        return f"{color}{msg}{_RESET}" if color and sys.stdout.isatty() else msg


class _MainProcessFilter(logging.Filter):
    def filter(self, record) -> bool:
        return is_main_process()


@functools.lru_cache()
def setup_logger(name: str = "maskbit_tpu_torch", log_level: int = logging.INFO,
                 output_file: Optional[str] = None,
                 main_process_only: bool = True) -> logging.Logger:
    """The logger `name` at `log_level`, to stdout and, with `output_file`,
    to that file (a local path, or a `scheme://` URL through fsspec)."""
    logger = logging.getLogger(name)
    logger.setLevel(log_level)
    handlers = [logging.StreamHandler(sys.stdout)]
    handlers[0].setFormatter(_ColorFormatter(_FORMAT))
    if output_file:
        if "://" in output_file:
            fh = _RateLimitedFlushHandler(_cached_log_stream(output_file))
        else:
            os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
            fh = logging.FileHandler(output_file)
        fh.setFormatter(logging.Formatter(_FORMAT))
        handlers.append(fh)
    for handler in handlers:
        if main_process_only:
            handler.addFilter(_MainProcessFilter())
        logger.addHandler(handler)
    return logger


class _RateLimitedFlushHandler(logging.StreamHandler):
    """A StreamHandler whose flush pushes the remote buffer at most every
    `interval` seconds: a crash loses at most that much of the log's tail,
    and the lines in between go out in few requests."""

    def __init__(self, stream, interval: float = 60.0):
        super().__init__(stream)
        self._interval = interval
        self._last_flush = time.monotonic()

    def flush(self):
        now = time.monotonic()
        if now - self._last_flush < self._interval:
            return
        self._last_flush = now
        with self.lock:
            try:
                self.stream.flush(force=True)  # fsspec: commit below the block size
            except TypeError:
                self.stream.flush()


@functools.lru_cache(maxsize=None)
def _cached_log_stream(filename: str):
    """One buffered text stream per remote log path, closed (so flushed) at
    exit. Object stores that cannot append get a fresh object."""
    import fsspec

    try:
        stream = fsspec.open(filename, "a", buffering=1024 * 1024).open()
    except (OSError, ValueError, NotImplementedError):
        stream = fsspec.open(filename, "w", buffering=1024 * 1024).open()
    atexit.register(stream.close)
    return stream
