"""Write an ImageNet-style directory into webdataset-format tar shards.

Counterpart of `maskbit_tpu/data/shard_writer.py` (the original repo's
scripts/create_sharded_dataset.py): shuffled `{key}.jpg` + `{key}.cls` tar
members, `maxcount` samples a shard (default 5079, so that the 1,281,167
ImageNet train images fill 253 shards), class ids from the sorted synset
list. The same file list and seed give the same tar members, byte for byte,
as the JAX package writes.
"""

from __future__ import annotations

import io
import os
import random
import tarfile
from typing import List, Optional, Sequence, Tuple


def list_imagenet_files(root: str, synsets: Optional[Sequence[str]] = None
                        ) -> List[Tuple[str, int]]:
    """[(path, class_id)] with class ids assigned by sorted synset order."""
    if synsets is None:
        synsets = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    files = []
    for class_id, synset in enumerate(synsets):
        class_dir = os.path.join(root, synset)
        if not os.path.isdir(class_dir):
            continue
        for fname in sorted(os.listdir(class_dir)):
            if fname.lower().endswith((".jpg", ".jpeg", ".png")):
                files.append((os.path.join(class_dir, fname), class_id))
    return files


class ShardWriter:
    """Sequentially write samples into `output_pattern % index` shards
    (e.g. /path/imagenet-train-%04d.tar)."""

    def __init__(self, output_pattern: str, maxcount: int = 5079):
        self.output_pattern = output_pattern
        self.maxcount = maxcount
        self.shard_index = 0
        self.count_in_shard = 0
        self.total = 0
        self._tar: Optional[tarfile.TarFile] = None

    def _next_shard(self):
        if self._tar is not None:
            self._tar.close()
        path = self.output_pattern % self.shard_index
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._tar = tarfile.open(path, "w")
        self.shard_index += 1
        self.count_in_shard = 0

    def write(self, key: str, jpg_bytes: bytes, class_id: int):
        if self._tar is None or self.count_in_shard >= self.maxcount:
            self._next_shard()
        for ext, data in (("jpg", jpg_bytes), ("cls", str(class_id).encode())):
            info = tarfile.TarInfo(name=f"{key}.{ext}")
            info.size = len(data)
            self._tar.addfile(info, io.BytesIO(data))
        self.count_in_shard += 1
        self.total += 1

    def close(self):
        if self._tar is not None:
            self._tar.close()
            self._tar = None


def create_sharded_dataset(data_root: str, output_pattern: str, maxcount: int = 5079,
                           shuffle: bool = True, seed: int = 0,
                           synsets: Optional[Sequence[str]] = None) -> int:
    """Shard an ImageNet directory; returns the number of samples written."""
    files = list_imagenet_files(data_root, synsets)
    if shuffle:
        random.Random(seed).shuffle(files)
    writer = ShardWriter(output_pattern, maxcount=maxcount)
    try:
        for i, (path, class_id) in enumerate(files):
            with open(path, "rb") as f:
                writer.write(f"{i:08d}", f.read(), class_id)
    finally:
        writer.close()
    return writer.total
