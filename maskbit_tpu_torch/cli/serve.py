"""Batch-inference HTTP server for class-conditional generation (PyTorch).

Counterpart of `maskbit_tpu/cli/serve.py`, on the process's CUDA cards:

    python -m maskbit_tpu_torch.cli.serve config=configs/generator/maskbit_generator_14bit.yaml \\
        experiment.vqgan_checkpoint=... experiment.generator_checkpoint=... \\
        serve.port=8000 serve.batch_size=24 serve.device=cuda

  * requests are padded and chunked to the fixed `serve.batch_size`;
  * a lock serialises device work; handler threads overlap parsing and
    serialisation with it;
  * UNSEEDED requests from concurrent clients are micro-batched by a worker
    thread into the fixed batch (bounded by a short fill window); requests
    with an explicit `seed` take the deterministic path: the same
    (labels, seed) gives the same bytes, each chunk drawing from a
    `torch.Generator` seeded from (seed, chunk offset). Images for a seed
    differ from the JAX server's, whose random streams are other ones.
  * `serve.device` (default "cuda") names the device; CUDA requested and
    absent is an error, there is no CPU fallback;
  * with `serve.shard_local_devices=true`, more than one local device
    (`sampling.serve.local_devices`: every visible card for an unindexed
    "cuda") and a batch that divides over them, each batch is split over
    them (`sampling.serve.make_sharded_sampler`: a worker process and a
    replica per card, holding this process's weights), as the JAX server
    shards over its local chips; otherwise one device runs the whole
    batch. The default is false, unlike JAX's: on four H100s a split call
    of 8 images ran at 0.991x the whole batch's speed on one card over 2
    cards and 0.923x over 4 (PERF.md): at that batch each card's work is
    too small to pay for a second card. The workers start with the
    service and stop with `close()` (and with `main`'s server); one that
    dies or hangs fails the requests in flight. A seeded request gives
    the same bytes for a given number of devices.

Endpoints:
  GET  /healthz            -> {"status": "ok", "warm": true, "batch_size": b}
  POST /generate           body {"labels": [int,...], "seed": int?,
                                 "format": "npy"|"npz"|"png"?}
       -> npy: npz bytes {"images": (n,h,w,3) uint8}; png: a PNG grid

Request caps (config): serve.max_labels (default 2048) and
serve.max_body_bytes (default 1 MiB).
"""

from __future__ import annotations

import collections
import io
import json
import logging
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from maskbit_tpu_torch.sampling.serve import derive_seed


class _PendingRequest:
    """One in-flight batched request: filled slot by slot by the worker."""

    __slots__ = ("result", "remaining", "event", "error")

    def __init__(self, n: int, h: int, w: int):
        self.result = np.empty((n, h, w, 3), np.uint8)
        self.remaining = n
        self.event = threading.Event()
        self.error: Exception | None = None


def _logger() -> logging.Logger:
    logger = logging.getLogger("maskbit_torch_serve")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("[%(asctime)s %(name)s %(levelname)s]: %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class GeneratorService:
    """Owns the models and the sampler; thread-safe generate()."""

    def __init__(self, config):
        from maskbit_tpu_torch.cli.common import load_generation_models, validate_generator_config
        from maskbit_tpu_torch.sampling import serve as split
        from maskbit_tpu_torch.sampling.sample import make_sampler

        validate_generator_config(config)
        self.logger = _logger()
        self.device = torch.device(config.select("serve.device", "cuda"))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("serve.device is cuda but no CUDA device is available")
        tokenizer, generator, sampling_cfg, _, _ = load_generation_models(
            config, self.logger, self.device, cast_weights=True)
        self.batch = int(config.select("serve.batch_size", 24))
        devices = split.local_devices(self.device)
        n_local = len(devices)
        if n_local > 1 and self.batch % n_local == 0 and \
                config.select("serve.shard_local_devices", False):
            # several local cards: split each serving batch over them
            # (weights replicated, a worker process per card)
            self.logger.info(f"sharding serving batch {self.batch} over {n_local} local devices")
            self._sampler = split.make_sharded_sampler(generator, tokenizer, sampling_cfg,
                                                       devices)
        else:
            self._sampler = make_sampler(generator, tokenizer, sampling_cfg)
        self.nclass = int(config.model.mlm_model.get("nclass", 1000))
        self.max_labels = int(config.select("serve.max_labels", 2048))
        self.max_body_bytes = int(config.select("serve.max_body_bytes", 1 << 20))
        # fill window after the first pending label before dispatch
        self.batch_wait = float(config.select("serve.batch_wait_ms", 10)) / 1e3
        self._lock = threading.Lock()
        self.warm = False
        self._default_seed = int(config.select("training.seed", 42))
        self.device_calls = 0  # sampler invocations
        self._img_hw: tuple[int, int] | None = None
        self._units: collections.deque = collections.deque()
        self._units_cv = threading.Condition()
        self._batch_counter = 0
        self._stop = False
        self._worker: threading.Thread | None = None

    def warmup(self) -> float:
        t0 = time.perf_counter()
        imgs = self.generate([0] * self.batch, seed=0)
        dt = time.perf_counter() - t0
        self._img_hw = imgs.shape[1:3]
        self.warm = True
        self._worker = threading.Thread(target=self._worker_loop, daemon=True)
        self._worker.start()
        self.logger.info(f"warmup run: {dt:.1f}s at batch {self.batch}")
        return dt

    def close(self) -> None:
        """Stop the micro-batching thread and the split sampler's workers."""
        with self._units_cv:
            self._stop = True
            self._units_cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=5)
        if hasattr(self._sampler, "close"):
            with self._lock:
                self._sampler.close()

    def _validate(self, labels) -> np.ndarray:
        labels = np.asarray(labels, np.int32)
        if labels.ndim != 1 or len(labels) == 0:
            raise ValueError("labels must be a non-empty 1-D int list")
        if len(labels) > self.max_labels:
            raise ValueError(f"at most {self.max_labels} labels per request")
        if labels.min() < 0 or labels.max() >= self.nclass:
            raise ValueError(f"labels must be in [0, {self.nclass})")
        return labels

    def _run(self, padded: np.ndarray, seed: int, n_out: int) -> np.ndarray:
        """One sampler call at the fixed batch; caller holds the lock."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        labels = torch.from_numpy(padded).to(self.device)
        images, _ = self._sampler(labels, gen)
        self.device_calls += 1
        images = images[:n_out].float().clamp(0.0, 1.0).cpu().numpy()
        return (images * 255.0 + 0.5).astype(np.uint8)

    def generate(self, labels, seed=None) -> np.ndarray:
        """Deterministic path: same (labels, seed) -> same bytes. Chunks to
        the fixed batch under the device lock."""
        labels = self._validate(labels)
        seed = self._default_seed if seed is None else int(seed)
        out = []
        with self._lock:
            for i0 in range(0, len(labels), self.batch):
                chunk = labels[i0 : i0 + self.batch]
                padded = np.zeros((self.batch,), np.int32)
                padded[: len(chunk)] = chunk
                out.append(self._run(padded, derive_seed(seed, i0), len(chunk)))
        return np.concatenate(out, axis=0)

    def generate_batched(self, labels, timeout: float = 600.0) -> np.ndarray:
        """Micro-batched path for unseeded requests: label slots from
        concurrent requests aggregate into one fixed-batch sampler call."""
        labels = self._validate(labels)
        if self._img_hw is None:  # not warmed up yet
            return self.generate(labels)
        pending = _PendingRequest(len(labels), *self._img_hw)
        with self._units_cv:
            for j, lab in enumerate(labels):
                self._units.append((pending, j, int(lab)))
            self._units_cv.notify()
        if not pending.event.wait(timeout):
            raise RuntimeError("generation timed out")
        if pending.error is not None:
            raise pending.error
        return pending.result

    def _worker_loop(self) -> None:
        while True:
            with self._units_cv:
                while not self._units and not self._stop:
                    self._units_cv.wait()
                if self._stop:
                    # fail queued requests fast instead of leaving their
                    # handler threads blocked until the wait timeout
                    while self._units:
                        pending, _, _ = self._units.popleft()
                        pending.error = RuntimeError("server shutting down")
                        pending.event.set()
                    return
            deadline = time.monotonic() + self.batch_wait
            while len(self._units) < self.batch:
                rest = deadline - time.monotonic()
                if rest <= 0:
                    break
                time.sleep(min(rest, 0.002))
            with self._units_cv:
                take = min(self.batch, len(self._units))
                units = [self._units.popleft() for _ in range(take)]
            try:
                padded = np.zeros((self.batch,), np.int32)
                for i, (_, _, lab) in enumerate(units):
                    padded[i] = lab
                with self._lock:
                    self._batch_counter += 1
                    arr8 = self._run(padded, derive_seed(self._default_seed, self._batch_counter),
                                     len(units))
                for i, (pending, j, _) in enumerate(units):
                    pending.result[j] = arr8[i]
                    pending.remaining -= 1  # single worker thread: no race
                    if pending.remaining == 0:
                        pending.event.set()
            except Exception as e:  # noqa: BLE001 — fail the waiting requests
                self.logger.error(f"batched generate failed: {e!r}")
                for pending, _, _ in units:
                    pending.error = e
                    pending.event.set()


def _png_grid(images: np.ndarray) -> bytes:
    from PIL import Image

    n, h, w, _ = images.shape
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, img in enumerate(images):
        r, c = divmod(i, cols)
        grid[r * h : (r + 1) * h, c * w : (c + 1) * w] = img
    buf = io.BytesIO()
    Image.fromarray(grid).save(buf, format="PNG")
    return buf.getvalue()


def make_handler(service: GeneratorService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            service.logger.info("http: " + fmt % args)

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj) -> None:
            self._reply(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "warm": service.warm,
                                 "batch_size": service.batch})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length > service.max_body_bytes:
                    self._json(400, {"error": f"request body over "
                                     f"{service.max_body_bytes} bytes"})
                    return
                req = json.loads(self.rfile.read(length) or b"{}")
                if req.get("seed") is not None:
                    images = service.generate(req.get("labels", []), req["seed"])
                else:
                    images = service.generate_batched(req.get("labels", []))
                fmt = req.get("format", "npy")
                if fmt == "png":
                    self._reply(200, _png_grid(images), "image/png")
                else:
                    buf = io.BytesIO()
                    if fmt == "npz":
                        np.savez_compressed(buf, images=images)
                    else:
                        np.savez(buf, images=images)
                    self._reply(200, buf.getvalue(), "application/octet-stream")
            except ValueError as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — serving must not die
                service.logger.error(f"/generate failed: {e!r}")
                self._json(500, {"error": repr(e)})

    return Handler


def main(argv=None, serve_forever: bool = True):
    from maskbit_tpu_torch.core.config import config_from_cli

    config = config_from_cli(argv if argv is not None else sys.argv[1:])
    service = GeneratorService(config)
    try:
        service.warmup()
        port = int(config.select("serve.port", 8000))
        server = ThreadingHTTPServer(("127.0.0.1", port), make_handler(service))
    except BaseException:
        service.close()
        raise
    service.logger.info(f"serving on 127.0.0.1:{server.server_address[1]}")
    if serve_forever:
        try:
            server.serve_forever()
        finally:
            server.server_close()
            service.close()
    return server, service


if __name__ == "__main__":
    main()
