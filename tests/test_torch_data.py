"""Port parity: the input pipeline against the JAX package's, on the CPU.

Same inputs, made from a seed with numpy, through both packages:
* `expand_shard_pattern` (brace, glob, plain path, a list mixing them, a
  tuple): equal lists;
* the transforms: equal float32 arrays (the same PIL resampling on the same
  crop and flip draws), exactly;
* the shard writer and `make_shards`: the same tar files, byte for byte;
* the tar reader in train (resampled shards, shuffle buffer) and eval
  (sequential) modes with the thread and process decode backends, and
  `SimpleImagenet`: the same `image` and `class_id` batches in the same
  order, exactly;
* the native decode backend: the same stream as JAX's native backend,
  exactly, and refused when its library cannot be built;
* token shards written by either package: the same batches read back by
  both, with resample on and off, exactly.
"""

import io
import itertools
import os

import numpy as np
import pytest
from PIL import Image

from maskbit_tpu.cli import make_shards as jax_make_shards
from maskbit_tpu.data import shard_writer as jax_shard_writer
from maskbit_tpu.data import tar_reader as jax_tar
from maskbit_tpu.data import token_shards as jax_tokens
from maskbit_tpu.data import transforms as jax_tf
from maskbit_tpu_torch.cli import common as port_common
from maskbit_tpu_torch.cli import make_shards as port_make_shards
from maskbit_tpu_torch.data import shard_writer as port_shard_writer
from maskbit_tpu_torch.data import tar_reader as port_tar
from maskbit_tpu_torch.data import token_shards as port_tokens
from maskbit_tpu_torch.data import transforms as port_tf


def _shard_files(tmp_path):
    for i in range(3):
        (tmp_path / f"s-{i:04d}.tar").write_bytes(b"")
    (tmp_path / "other.tar").write_bytes(b"")
    return str(tmp_path)


@pytest.mark.parametrize("kind", ["brace", "glob", "plain", "mixed_list", "tuple"])
def test_expand_shard_pattern_matches_jax(tmp_path, kind):
    d = _shard_files(tmp_path)
    brace, glob, plain = f"{d}/s-{{0000..0002}}.tar", f"{d}/s-*.tar", f"{d}/other.tar"
    pattern = {"brace": brace, "glob": glob, "plain": plain,
               "mixed_list": [plain, brace, glob], "tuple": (glob, plain)}[kind]
    want = jax_tar.expand_shard_pattern(pattern)
    assert port_tar.expand_shard_pattern(pattern) == want
    assert port_common.expand_shard_pattern is port_tar.expand_shard_pattern
    assert len(want) == {"brace": 3, "glob": 3, "plain": 1, "mixed_list": 7, "tuple": 4}[kind]


def _image(rng, w, h):
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


@pytest.mark.parametrize("interpolation", ["bilinear", "bicubic", "nearest", "lanczos"])
@pytest.mark.parametrize("aspect,crop", [(True, True), (False, True), (True, False)])
def test_train_transform_matches_jax(interpolation, aspect, crop):
    import random

    rng = np.random.default_rng(1)
    kwargs = dict(resolution=24, min_scale=0.5, use_aspect_ratio_aug=aspect,
                  use_random_crop=crop, interpolation=interpolation, seed=3)
    jt, pt = jax_tf.TrainTransform(**kwargs), port_tf.TrainTransform(**kwargs)
    for i, (w, h) in enumerate([(40, 30), (30, 50), (24, 24), (64, 20)]):
        img = _image(rng, w, h)
        np.testing.assert_array_equal(pt(img), jt(img))  # the instance rng
        got = pt(img, rng=random.Random(f"s-{i}"))
        want = jt(img, rng=random.Random(f"s-{i}"))
        assert got.dtype == np.float32 and got.shape == (24, 24, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [(40, 30), (30, 50), (16, 16)])
def test_eval_transform_and_helpers_match_jax(size):
    import random

    rng = np.random.default_rng(2)
    img = _image(rng, *size)
    np.testing.assert_array_equal(port_tf.EvalTransform(20, "bicubic")(img),
                                  jax_tf.EvalTransform(20, "bicubic")(img))
    resized = port_tf.resize_shorter_side(img, 20, Image.BILINEAR)
    assert resized.size == jax_tf.resize_shorter_side(img, 20, Image.BILINEAR).size
    assert port_tf.center_crop(resized, 20).tobytes() == jax_tf.center_crop(resized, 20).tobytes()
    for seed in range(20):
        args = (size[1], size[0], (0.08, 1.0), (3 / 4, 4 / 3))
        assert (port_tf.random_resized_crop_params(*args, random.Random(seed))
                == jax_tf.random_resized_crop_params(*args, random.Random(seed)))


def _jpeg(rng, w, h):
    buf = io.BytesIO()
    _image(rng, w, h).save(buf, format="JPEG")
    return buf.getvalue()


def _imagenet_dir(root, rng):
    """An ImageNet-style directory: 3 synsets, 4 JPEGs of mixed sizes each."""
    for s in range(3):
        d = root / f"n0000{s}"
        d.mkdir(parents=True)
        for i in range(4):
            (d / f"img{i}.JPEG").write_bytes(_jpeg(rng, 20 + 3 * i, 18 + 2 * s))
    return str(root)


@pytest.fixture
def shards(tmp_path):
    """Tar shards of 12 samples (5 a shard) written by the port's writer."""
    data = _imagenet_dir(tmp_path / "imagenet", np.random.default_rng(0))
    pattern = str(tmp_path / "shards" / "train-%04d.tar")
    assert port_shard_writer.create_sharded_dataset(data, pattern, maxcount=5, seed=1) == 12
    return str(tmp_path / "shards" / "train-{0000..0002}.tar")


@pytest.mark.parametrize("shuffle", [True, False])
def test_shard_writer_and_make_shards_match_jax(tmp_path, shuffle):
    data = _imagenet_dir(tmp_path / "imagenet", np.random.default_rng(0))
    kwargs = dict(maxcount=5, shuffle=shuffle, seed=4)
    n_port = port_shard_writer.create_sharded_dataset(data, str(tmp_path / "p-%04d.tar"), **kwargs)
    n_jax = jax_shard_writer.create_sharded_dataset(data, str(tmp_path / "j-%04d.tar"), **kwargs)
    assert n_port == n_jax == 12
    assert (port_shard_writer.list_imagenet_files(data)
            == jax_shard_writer.list_imagenet_files(data))
    argv = ["--data_root", data, "--maxcount", "5", "--seed", "4"] + ([] if shuffle else
                                                                      ["--no-shuffle"])
    assert port_make_shards.main(argv + ["--output", str(tmp_path / "pc-%04d.tar")]) == 12
    jax_make_shards.main(argv + ["--output", str(tmp_path / "jc-%04d.tar")])
    for i in range(3):
        want = (tmp_path / f"j-{i:04d}.tar").read_bytes()
        assert (tmp_path / f"p-{i:04d}.tar").read_bytes() == want
        assert (tmp_path / f"pc-{i:04d}.tar").read_bytes() == want
        assert (tmp_path / f"jc-{i:04d}.tar").read_bytes() == want
    assert not (tmp_path / "p-0003.tar").exists()


def _batches(module, shards, mode, backend, n_batches):
    if mode == "train":
        transform = module[1].TrainTransform(resolution=16, min_scale=0.5, interpolation="bicubic",
                                             seed=7)
        ds = module[0].TarImageDataset(shards, transform, resample=True, shuffle_buffer_size=4,
                                       seed=7, num_decode_threads=2, decode_backend=backend)
    else:
        transform = module[1].EvalTransform(resolution=16)
        ds = module[0].TarImageDataset(shards, transform, resample=False, seed=7,
                                       num_decode_threads=2, decode_backend=backend)
    it = module[0].batched(iter(ds), 4, drop_last=mode == "train")
    return [next(it) for _ in range(n_batches)] if mode == "train" else list(it)


@pytest.mark.parametrize("backend", ["thread", "process"])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_tar_reader_matches_jax(shards, mode, backend):
    got = _batches((port_tar, port_tf), shards, mode, backend, 5)
    want = _batches((jax_tar, jax_tf), shards, mode, "thread", 5)
    assert len(got) == len(want) == (5 if mode == "train" else 3)
    for g, w in zip(got, want):
        assert g["image"].dtype == np.float32 and g["class_id"].dtype == np.int32
        np.testing.assert_array_equal(g["class_id"], w["class_id"])
        np.testing.assert_array_equal(g["image"], w["image"])
    if mode == "eval":
        assert sorted(np.concatenate([b["class_id"] for b in got]).tolist()) == [0] * 4 + [1] * 4 + [2] * 4


def test_simple_imagenet_matches_jax(shards):
    kwargs = dict(train_shards_path_or_url=shards, eval_shards_path_or_url=shards,
                  num_train_examples=12, per_device_batch_size=3, global_batch_size=3,
                  num_workers_per_device=2, resolution=16, shuffle_buffer_size=4, seed=5,
                  process_index=0, process_count=1, decode_backend="thread")
    port, jax_data = port_tar.SimpleImagenet(**kwargs), jax_tar.SimpleImagenet(**kwargs)
    assert (port.num_batches, port.num_samples) == (jax_data.num_batches, jax_data.num_samples)
    got, want = port.train_dataloader, jax_data.train_dataloader
    for _ in range(4):
        g, w = next(got), next(want)
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["class_id"], w["class_id"])
    for g, w in zip(port.eval_dataloader, jax_data.eval_dataloader, strict=True):
        np.testing.assert_array_equal(g["image"], w["image"])


def test_tar_reader_refuses_the_native_decoder(shards, tmp_path, monkeypatch):
    """`decode_backend="native"` runs (the port's C++ decoder, the same
    stream as JAX's "native", exactly) and is refused only when the library
    cannot be built; unknown backends and empty shard lists are refused."""
    from maskbit_tpu import native as jax_native
    from maskbit_tpu_torch import native

    transform = lambda tf: tf.TrainTransform(resolution=16, seed=3)  # noqa: E731
    common = dict(shuffle_buffer_size=4, seed=2, num_decode_threads=2, decode_backend="native")
    got = list(itertools.islice(iter(port_tar.TarImageDataset(shards, transform(port_tf),
                                                              **common)), 12))
    if jax_native.is_available():
        want = list(itertools.islice(iter(jax_tar.TarImageDataset(shards, transform(jax_tf),
                                                                  **common)), 12))
        for (g, gl), (w, wl) in zip(got, want, strict=True):
            assert gl == wl
            np.testing.assert_array_equal(g, w)
    assert len(got) == 12 and got[0][0].shape == (16, 16, 3)
    # a library that cannot be built: "native" raises, as in JAX
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "nowhere")
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ["-DMB_FORCED_ERROR", "-include",
                                                                 "/nonexistent/forced.h"])
    with pytest.raises(ValueError, match="could not be built"):
        port_tar.TarImageDataset(shards, port_tf.EvalTransform(16), decode_backend="native")
    with pytest.raises(ValueError, match="decode_backend"):
        port_tar.TarImageDataset(shards, port_tf.EvalTransform(16), decode_backend="fork")
    with pytest.raises(ValueError, match="No shards"):
        port_tar.TarImageDataset([], port_tf.EvalTransform(16))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_token_shards_match_jax(tmp_path, writer):
    rng = np.random.default_rng(3)
    module = port_tokens if writer == "port" else jax_tokens
    w = module.TokenShardWriter(str(tmp_path / "tok-%04d.npz"), maxcount=10)
    tokens = rng.integers(0, 2**14, size=(25, 16)).astype(np.int64)
    labels = rng.integers(0, 1000, size=(25,))
    for i in range(0, 25, 5):
        w.write_batch(tokens[i:i + 5], labels[i:i + 5])
    w.close()
    assert w.total == 25 and sorted(os.listdir(tmp_path)) == [f"tok-{i:04d}.npz" for i in range(3)]
    pattern = str(tmp_path / "tok-{0000..0002}.npz")
    seq = list(port_tokens.TokenShardDataset(pattern, resample=False).batches(8, drop_last=False))
    np.testing.assert_array_equal(np.concatenate([b["tokens"] for b in seq]), tokens)
    for resample, drop_last, n in ((False, False, 4), (False, True, 3), (True, True, 9)):
        got = port_tokens.TokenShardDataset(pattern, resample=resample, seed=2).batches(
            8, drop_last=drop_last)
        want = jax_tokens.TokenShardDataset(pattern, resample=resample, seed=2).batches(
            8, drop_last=drop_last)
        for _ in range(n):
            g, wb = next(got), next(want)
            assert g["tokens"].dtype == np.int32 and g["class_id"].dtype == np.int32
            np.testing.assert_array_equal(g["tokens"], wb["tokens"])
            np.testing.assert_array_equal(g["class_id"], wb["class_id"])
        if not resample:
            assert next(got, None) is None and next(want, None) is None
