"""Pre-tokenized dataset: encode the images once, train Stage-II from tokens.

Counterpart of `maskbit_tpu/data/token_shards.py`. Training from tokens takes
the frozen Stage-I encoder out of every train step and shrinks the input to
integer token shards (about 0.5 KB an image instead of a JPEG decode).
Pre-tokenizing freezes the augmentation: one crop and flip per image per
pass written.

Shard format (the JAX package's): `.npz` with `tokens` (N, seq_len) int32 and
`labels` (N,) int32. A train stream draws shards with replacement and visits
each shard's samples in a shuffled order, all from
`random.Random(f"{seed}-{process_index}-tokens")`.
"""

from __future__ import annotations

import os
import random
from typing import Iterator, List

import numpy as np

from maskbit_tpu_torch.data.tar_reader import expand_shard_pattern


class TokenShardWriter:
    def __init__(self, output_pattern: str, maxcount: int = 50_000):
        self.output_pattern = output_pattern
        self.maxcount = maxcount
        self.shard_index = 0
        self.total = 0
        self._tokens: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []
        self._count = 0

    def write_batch(self, tokens: np.ndarray, labels: np.ndarray) -> None:
        self._tokens.append(np.asarray(tokens, np.int32))
        self._labels.append(np.asarray(labels, np.int32))
        self._count += len(labels)
        self.total += len(labels)
        if self._count >= self.maxcount:
            self._flush()

    def _flush(self) -> None:
        if not self._tokens:
            return
        path = self.output_pattern % self.shard_index
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez_compressed(path, tokens=np.concatenate(self._tokens),
                            labels=np.concatenate(self._labels))
        self.shard_index += 1
        self._tokens, self._labels, self._count = [], [], 0

    def close(self) -> None:
        self._flush()


class TokenShardDataset:
    """Batches of pre-tokenized samples with train (resampled, shuffled) or
    eval (sequential) semantics."""

    def __init__(self, shards, *, resample: bool = True, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        self.shards = expand_shard_pattern(shards)
        if not self.shards:
            raise ValueError(f"No token shards matched {shards!r}")
        self.resample = resample
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count

    def batches(self, batch_size: int, drop_last: bool = True) -> Iterator[dict]:
        rng = random.Random(f"{self.seed}-{self.process_index}-tokens")
        buf_tokens: list = []
        buf_labels: list = []

        def shard_iter():
            if self.resample:
                while True:
                    yield rng.choice(self.shards)
            else:
                yield from self.shards[self.process_index::self.process_count]

        for shard in shard_iter():
            with np.load(shard) as data:
                tokens, labels = data["tokens"], data["labels"]
            order = (rng.sample(range(len(labels)), len(labels)) if self.resample
                     else range(len(labels)))
            for i in order:
                buf_tokens.append(tokens[i])
                buf_labels.append(labels[i])
                if len(buf_labels) == batch_size:
                    yield {"tokens": np.stack(buf_tokens),
                           "class_id": np.asarray(buf_labels, np.int32)}
                    buf_tokens, buf_labels = [], []
        if buf_labels and not drop_last:
            yield {"tokens": np.stack(buf_tokens), "class_id": np.asarray(buf_labels, np.int32)}
