"""Tar-shard input pipeline (webdataset format, no external dependencies).

Counterpart of `maskbit_tpu/data/tar_reader.py`, with the same streams for
the same seed:
  * shards are .tar files of `{key}.jpg` + `{key}.cls` members;
  * train: shards drawn with replacement forever, a seeded shuffle buffer,
    a per-sample transform, drop-last batches;
  * eval: the shard list in order, split across processes, no shuffle;
  * `num_batches` / `num_samples` bookkeeping.
Decode and transform run in a thread pool (or, with `decode_backend=
"process"`, a pool of spawned processes) feeding a bounded prefetch queue;
batches are NHWC float32 numpy arrays. Each sample's augmentation draws from
`random.Random(f"{seed}-{process_index}-sample-{i}")`, i its place in the
stream, so the decoded stream is the same across backends and runs.
`process_index` and `process_count` come from the caller (default 0 and 1).
`decode_backend="native"` decodes, crops, resizes and flips JPEG members in
one C++ pass (`maskbit_tpu_torch/native`) on the thread pool, with the same
crop and flip draws as the PIL path; PNG members, the `nearest` and
`lanczos` filters and undecodable bytes take the PIL path, as in JAX.
"""

from __future__ import annotations

import io
import itertools
import os
import queue
import random
import re
import tarfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from maskbit_tpu_torch.data.transforms import EvalTransform, TrainTransform

_BRACE_RE = re.compile(r"^(.*)\{(\d+)\.\.(\d+)\}(.*)$")
DECODE_BACKENDS = ("thread", "process", "native")


def expand_shard_pattern(pattern) -> List[str]:
    """'imagenet-train-{0000..0252}.tar' -> the shard list; a plain path, a
    glob, or a list or tuple of any of these also works."""
    if isinstance(pattern, (list, tuple)):
        out: List[str] = []
        for p in pattern:
            out.extend(expand_shard_pattern(p))
        return out
    m = _BRACE_RE.match(pattern)
    if m:
        prefix, lo, hi, suffix = m.groups()
        return [f"{prefix}{i:0{len(lo)}d}{suffix}" for i in range(int(lo), int(hi) + 1)]
    if any(ch in pattern for ch in "*?["):
        import glob

        return sorted(glob.glob(pattern))
    return [pattern]


def iterate_tar_samples(path: str) -> Iterator[Dict[str, bytes]]:
    """Group tar members by key prefix: {'__key__', 'jpg', 'cls', ...}."""
    with tarfile.open(path, "r") as tar:
        current_key: Optional[str] = None
        sample: Dict[str, bytes] = {}
        for member in tar:
            if not member.isfile() or "." not in member.name:
                continue
            key, ext = member.name.split(".", 1)
            if key != current_key:
                if current_key is not None and sample:
                    yield dict(sample, __key__=current_key.encode())
                current_key = key
                sample = {}
            data = tar.extractfile(member)
            if data is not None:
                sample[ext.lower()] = data.read()
        if current_key is not None and sample:
            yield dict(sample, __key__=current_key.encode())


def _decode_sample(sample: Dict[str, bytes], transform: Callable,
                   sample_seed: Optional[str] = None) -> Optional[Tuple[np.ndarray, int]]:
    from PIL import Image

    img_bytes = next((sample[ext] for ext in ("jpg", "jpeg", "png", "webp") if ext in sample),
                     None)
    if img_bytes is None:
        return None
    label = int(sample["cls"].decode()) if "cls" in sample else -1
    img = Image.open(io.BytesIO(img_bytes))
    if sample_seed is not None and hasattr(transform, "rng"):
        return transform(img, rng=random.Random(sample_seed)), label
    return transform(img), label


def _decode_sample_native(sample: Dict[str, bytes], transform: Callable,
                          sample_seed: Optional[str] = None
                          ) -> Optional[Tuple[np.ndarray, int]]:
    """The C++ decoder: bytes -> crop -> resize -> flip in one pass. The crop
    and flip draws are the PIL path's functions in the same order, so the
    geometry is the same for a seed; only the resampling differs (about one
    LSB against PIL's bilinear). Non-JPEG members, filters the decoder lacks
    and undecodable bytes take the PIL path."""
    from maskbit_tpu_torch import native
    from maskbit_tpu_torch.data.transforms import random_resized_crop_params

    img_bytes = next((sample[ext] for ext in ("jpg", "jpeg") if ext in sample), None)
    interp = getattr(transform, "interpolation", "bilinear")
    if img_bytes is None or interp not in native.FILTERS:
        return _decode_sample(sample, transform, sample_seed)
    label = int(sample["cls"].decode()) if "cls" in sample else -1
    try:
        w, h = native.decode_info(img_bytes)
    except ValueError:
        return _decode_sample(sample, transform, sample_seed)
    if sample_seed is not None:
        rng = random.Random(sample_seed)
    else:
        rng = getattr(transform, "rng", random.Random(0))
    is_train = isinstance(transform, TrainTransform)
    if is_train and transform.use_random_crop:
        top, left, ch, cw = random_resized_crop_params(h, w, (transform.min_scale, 1.0),
                                                       transform.ratio, rng)
    else:
        side = min(w, h)
        top, left, ch, cw = (h - side) // 2, (w - side) // 2, side, side
    flip = is_train and rng.random() < 0.5
    res = transform.resolution
    try:
        out = native.decode_crop_resize(img_bytes, top, left, ch, cw, res, res, flip,
                                        interpolation=interp)
    except ValueError:
        return _decode_sample(sample, transform, sample_seed)
    return out.astype(np.float32) / 255.0, label


# The process backend: each worker binds the transform once; a sample's
# randomness travels with it as its seed, not with the worker.
_WORKER_TRANSFORM: Optional[Callable] = None


def _decode_pool_init(transform: Callable) -> None:
    global _WORKER_TRANSFORM
    _WORKER_TRANSFORM = transform


def _decode_in_worker(item: Tuple[Dict[str, bytes], Optional[str]]
                      ) -> Optional[Tuple[np.ndarray, int]]:
    sample, sample_seed = item
    return _decode_sample(sample, _WORKER_TRANSFORM, sample_seed)


class ShuffleBuffer:
    def __init__(self, size: int, rng: random.Random):
        self.size = size
        self.rng = rng
        self.buffer: list = []

    def __call__(self, iterator):
        for item in iterator:
            if len(self.buffer) < self.size:
                self.buffer.append(item)
                continue
            idx = self.rng.randrange(self.size)
            out, self.buffer[idx] = self.buffer[idx], item
            yield out
        self.rng.shuffle(self.buffer)
        yield from self.buffer
        self.buffer = []


class TarImageDataset:
    """Iterable dataset over tar shards with train (resample) or eval
    (sequential) semantics."""

    def __init__(self, shards, transform: Callable, *, resample: bool = True,
                 shuffle_buffer_size: int = 1000, seed: int = 0, process_index: int = 0,
                 process_count: int = 1, num_decode_threads: int = 8,
                 decode_backend: str = "thread"):
        self.shards = expand_shard_pattern(shards)
        if not self.shards:
            raise ValueError(f"No shards matched {shards!r}")
        if decode_backend not in DECODE_BACKENDS:
            raise ValueError(f"decode_backend must be one of {DECODE_BACKENDS}, "
                             f"got {decode_backend!r}")
        if decode_backend == "native":
            from maskbit_tpu_torch import native

            if not native.is_available():
                raise ValueError("decode_backend='native' but the C++ decoder could not be "
                                 f"built: {native.build_error()}")
        self.transform = transform
        self.resample = resample
        self.shuffle_buffer_size = shuffle_buffer_size
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.num_decode_threads = num_decode_threads
        self.decode_backend = decode_backend

    def _shard_iterator(self) -> Iterator[str]:
        if self.resample:
            rng = random.Random(f"{self.seed}-{self.process_index}")
            while True:
                yield rng.choice(self.shards)
        else:
            yield from itertools.islice(self.shards, self.process_index, None,
                                        self.process_count)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, int]]:
        rng = random.Random(f"{self.seed}-{self.process_index}-shuffle")
        samples = (s for shard in self._shard_iterator() for s in iterate_tar_samples(shard))
        if self.resample and self.shuffle_buffer_size > 1:
            samples = ShuffleBuffer(self.shuffle_buffer_size, rng)(samples)
        seed_base = f"{self.seed}-{self.process_index}-sample"
        indexed = ((s, f"{seed_base}-{i}") for i, s in enumerate(samples))

        # "native" runs the C++ decoder on the thread pool: it releases the
        # GIL for the whole decode, crop and resize
        decode = _decode_sample_native if self.decode_backend == "native" else _decode_sample
        if self.num_decode_threads <= 1:
            for s, ss in indexed:
                decoded = decode(s, self.transform, ss)
                if decoded is not None:
                    yield decoded
            return

        if self.decode_backend == "process":
            # spawn, not fork: the parent may hold CUDA state and threads
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            pool = ProcessPoolExecutor(self.num_decode_threads,
                                       mp_context=mp.get_context("spawn"),
                                       initializer=_decode_pool_init,
                                       initargs=(self.transform,))
            submit = lambda item: pool.submit(_decode_in_worker, item)  # noqa: E731
        else:
            pool = ThreadPoolExecutor(self.num_decode_threads)
            submit = lambda item: pool.submit(decode, item[0],  # noqa: E731
                                              self.transform, item[1])

        with pool:
            futures: "queue.Queue" = queue.Queue()
            sample_iter = iter(indexed)
            n_inflight = 0
            for item in itertools.islice(sample_iter, 2 * self.num_decode_threads):
                futures.put(submit(item))
                n_inflight += 1
            while n_inflight:
                fut = futures.get()
                n_inflight -= 1
                nxt = next(sample_iter, None)
                if nxt is not None:
                    futures.put(submit(nxt))
                    n_inflight += 1
                decoded = fut.result()
                if decoded is not None:
                    yield decoded


def batched(iterator, batch_size: int, drop_last: bool = True):
    """Collate (image, label) pairs into {'image': (b,h,w,c) f32, 'class_id': (b,)}."""
    imgs, labels = [], []
    for img, label in iterator:
        imgs.append(img)
        labels.append(label)
        if len(imgs) == batch_size:
            yield {"image": np.stack(imgs), "class_id": np.asarray(labels, np.int32)}
            imgs, labels = [], []
    if imgs and not drop_last:
        yield {"image": np.stack(imgs), "class_id": np.asarray(labels, np.int32)}


class PrefetchIterator:
    """Background-thread prefetch with a bounded queue."""

    _DONE = object()

    def __init__(self, iterable, buffer_size: int = 4):
        self._queue: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self._iterable = iterable
        self._exception = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._iterable:
                self._queue.put(item)
        except BaseException as e:  # handed to the consumer, which raises it
            self._exception = e
        finally:
            self._queue.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._DONE:
            if self._exception is not None:
                raise self._exception
            raise StopIteration
        return item


class SimpleImagenet:
    """The original repo's SimpleImagenet API: `.train_dataloader` and
    `.eval_dataloader` with num_batches / num_samples bookkeeping.
    `decode_backend` None reads MASKBIT_DECODE_BACKEND (default "thread")."""

    def __init__(self, train_shards_path_or_url, eval_shards_path_or_url,
                 num_train_examples: int, per_device_batch_size: int, global_batch_size: int,
                 num_workers_per_device: int = 8, resolution: int = 256,
                 shuffle_buffer_size: int = 1000, min_scale: float = 0.8,
                 use_aspect_ratio_aug: bool = True, use_random_crop: bool = True,
                 interpolation: str = "bilinear", seed: int = 0, process_index: int = 0,
                 process_count: int = 1, decode_backend: Optional[str] = None):
        if decode_backend is None:
            decode_backend = os.environ.get("MASKBIT_DECODE_BACKEND", "thread")
        self.per_host_batch_size = global_batch_size // process_count
        self.num_batches = int(np.ceil(num_train_examples / global_batch_size))
        self.num_samples = self.num_batches * global_batch_size

        train_transform = TrainTransform(
            resolution=resolution, min_scale=min_scale,
            use_aspect_ratio_aug=use_aspect_ratio_aug, use_random_crop=use_random_crop,
            interpolation=interpolation, seed=seed + process_index)
        eval_transform = EvalTransform(resolution=resolution, interpolation=interpolation)
        common = dict(seed=seed, process_index=process_index, process_count=process_count,
                      num_decode_threads=num_workers_per_device, decode_backend=decode_backend)
        self._train_dataset = TarImageDataset(train_shards_path_or_url, train_transform,
                                              resample=True,
                                              shuffle_buffer_size=shuffle_buffer_size, **common)
        self._eval_dataset = TarImageDataset(eval_shards_path_or_url, eval_transform,
                                             resample=False, **common)

    @property
    def train_dataloader(self):
        return PrefetchIterator(batched(iter(self._train_dataset), self.per_host_batch_size,
                                        drop_last=True))

    @property
    def eval_dataloader(self):
        return batched(iter(self._eval_dataset), self.per_host_batch_size, drop_last=False)
