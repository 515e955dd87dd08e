"""Port parity: the native (C++/libjpeg) JPEG decoder of `maskbit_tpu_torch`.

The port keeps its own copy of `decode.cc` and a loader that mirrors the
JAX package's; both build here with g++ and libjpeg.
* `decode_info` and `decode_crop_resize` give exactly the bytes of
  `maskbit_tpu.native`'s on the shards of `tests/test_native_decode.py`
  (every member, bilinear and bicubic, with and without the flip) and on a
  large source that the decoder scales in the DCT domain.
* The tar stream with `decode_backend="native"` equals the JAX package's
  "native" stream sample for sample (train and eval transforms), and
  follows the PIL stream within `tests/test_native_decode.py`'s
  tolerances: a mean absolute gap below 0.01 (bilinear train, with a 99.9th
  percentile below 0.25) or 0.012 (bicubic, eval), equal labels and order.
* `lanczos`, which the decoder lacks, and PNG members take the PIL path:
  equal to the PIL stream exactly.
* The library is named after its source's hash in the checkout's build
  directory, or, when that cannot be written, in the user cache; a forced
  build error makes `decode_backend="native"` raise.
"""

import io
import itertools
import tarfile

import numpy as np
import pytest
from PIL import Image

from maskbit_tpu import native as jax_native
from maskbit_tpu.data import tar_reader as jax_tar
from maskbit_tpu.data import transforms as jax_tf
from maskbit_tpu_torch import native
from maskbit_tpu_torch.data import tar_reader as port_tar
from maskbit_tpu_torch.data import transforms as port_tf
from maskbit_tpu_torch.utils.paths import user_cache_dir
from tests.test_native_decode import shard_dir  # noqa: F401 — the fixture

pytestmark = pytest.mark.skipif(
    not (native.is_available() and jax_native.is_available()),
    reason=f"native decoder unavailable: {native.build_error() or jax_native.build_error()}")


def _jpeg(h, w, seed=0) -> bytes:
    y, x = np.mgrid[0:h, 0:w]
    arr = np.stack([(x * 0.6 + seed) % 256, (y * 0.8) % 256, ((x + y) * 0.5) % 256],
                   -1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def _members(shard_dir):  # noqa: F811
    for path in sorted(shard_dir.glob("test-*.tar")):
        with tarfile.open(path) as tar:
            for m in tar:
                if m.name.endswith(".jpg"):
                    yield m.name, tar.extractfile(m).read()


@pytest.mark.parametrize("interpolation", ["bilinear", "bicubic"])
@pytest.mark.parametrize("flip", [False, True], ids=["plain", "flip"])
def test_decode_equals_jax_bytes(shard_dir, interpolation, flip):  # noqa: F811
    n = 0
    for name, data in _members(shard_dir):
        assert native.decode_info(data) == jax_native.decode_info(data), name
        w, h = native.decode_info(data)
        box = (h // 7, w // 5, h - h // 7 - h // 9, w - w // 5 - 1)
        for out in ((64, 64), (37, 50)):
            got = native.decode_crop_resize(data, *box, *out, flip, interpolation)
            want = jax_native.decode_crop_resize(data, *box, *out, flip, interpolation)
            assert got.tobytes() == want.tobytes(), (name, out)
        n += 1
    assert n >= 10


@pytest.mark.parametrize("interpolation", ["bilinear", "bicubic"])
def test_dct_scaled_large_source_equals_jax_bytes(interpolation):
    """A 1600x1200 source read into 32x32: the decoder scales by 1/8 in the
    DCT domain first."""
    data = _jpeg(1200, 1600, seed=3)
    assert native.decode_info(data) == (1600, 1200)
    for box in ((0, 0, 1200, 1600), (100, 250, 900, 1000)):
        got = native.decode_crop_resize(data, *box, 32, 32, True, interpolation)
        want = jax_native.decode_crop_resize(data, *box, 32, 32, True, interpolation)
        assert got.tobytes() == want.tobytes(), box
    np.testing.assert_array_equal(
        native.decode_crop_resize(data, 0, 0, 1200, 1600, 32, 32, True, interpolation),
        native.decode_crop_resize(data, 0, 0, 1200, 1600, 32, 32, False, interpolation)[:, ::-1])


def _stream(shard_dir, tar, backend, transform, n=15, threads=2, resample=True):  # noqa: F811
    ds = tar.TarImageDataset(str(shard_dir / "test-{0000..0002}.tar"), transform,
                             resample=resample, shuffle_buffer_size=8, seed=3,
                             num_decode_threads=threads, decode_backend=backend)
    return list(itertools.islice(iter(ds), n))


STREAMS = {
    "train-bilinear": (lambda tf: tf.TrainTransform(resolution=64, seed=7), True, 0.01),
    "train-bicubic": (lambda tf: tf.TrainTransform(resolution=64, seed=7,
                                                   interpolation="bicubic"), True, 0.012),
    "eval": (lambda tf: tf.EvalTransform(resolution=64), False, 0.012),
}


@pytest.mark.parametrize("case", list(STREAMS))
def test_native_stream_equals_jax_and_follows_pil(shard_dir, case):  # noqa: F811
    make, resample, mean_tol = STREAMS[case]
    got = _stream(shard_dir, port_tar, "native", make(port_tf), resample=resample)
    want = _stream(shard_dir, jax_tar, "native", make(jax_tf), resample=resample)
    pil = _stream(shard_dir, port_tar, "thread", make(port_tf), resample=resample)
    assert len(got) == len(want) == len(pil) == 15
    for (g, gl), (w, wl), (p, pl) in zip(got, want, pil):
        assert gl == wl == pl
        assert g.dtype == np.float32 and g.shape == p.shape == (64, 64, 3)
        np.testing.assert_array_equal(g, w)
        diff = np.abs(g - p)
        assert diff.mean() < mean_tol, diff.mean()
        if case == "train-bilinear":
            assert np.percentile(diff, 99.9) < 0.25


def test_lanczos_and_png_take_the_pil_path(shard_dir):  # noqa: F811
    make = lambda: port_tf.TrainTransform(resolution=64, seed=7,  # noqa: E731
                                          interpolation="lanczos")
    pil = _stream(shard_dir, port_tar, "thread", make(), n=8)
    nat = _stream(shard_dir, port_tar, "native", make(), n=8)
    for (p, pl), (g, gl) in zip(pil, nat, strict=True):
        assert pl == gl
        np.testing.assert_array_equal(p, g)
    # bilinear: the PNG members (every 7th from the 4th) equal PIL's exactly
    make = lambda: port_tf.TrainTransform(resolution=64, seed=7)  # noqa: E731
    samples = list(port_tar.iterate_tar_samples(str(shard_dir / "test-0000.tar")))
    png = [s for s in samples if "png" in s]
    assert png
    for s in png:
        a = port_tar._decode_sample_native(s, make(), "seed-1")
        b = port_tar._decode_sample(s, make(), "seed-1")
        assert a[1] == b[1]
        np.testing.assert_array_equal(a[0], b[0])


def test_library_build_places_and_forced_error(tmp_path, monkeypatch):
    path = native.lib_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libmaskbit_decode-")
    assert path.exists()
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert user_cache_dir("x") == str(tmp_path / "cache" / "maskbit_tpu_torch" / "x")
    try:
        # an unwritable checkout: the library builds into the user cache
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_build_error", None)
        monkeypatch.setattr(native.os, "access", lambda p, m: False)
        assert native.is_available(), native.build_error()
        assert native.lib_path(tmp_path / "cache" / "maskbit_tpu_torch").exists()
        assert native.decode_info(_jpeg(32, 48)) == (48, 32)
        # a build that fails: "native" raises at construction, as in JAX
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_build_error", None)
        monkeypatch.setattr(native, "GXX_FLAGS", ["-include", "/nonexistent/forced.h"])
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "other"))
        assert not native.is_available() and "forced.h" in native.build_error()
        with pytest.raises(RuntimeError, match="unavailable"):
            native.decode_info(_jpeg(32, 48))
        with pytest.raises(ValueError, match="could not be built"):
            port_tar.TarImageDataset(str(tmp_path / "x.tar"), port_tf.EvalTransform(16),
                                     decode_backend="native")
    finally:
        native._lib = None
        native._build_error = None


def test_invalid_jpeg_raises():
    with pytest.raises(ValueError):
        native.decode_info(b"not a jpeg at all")
    with pytest.raises(ValueError):
        native.decode_crop_resize(b"garbage", 0, 0, 10, 10, 8, 8, False)
    with pytest.raises(ValueError, match="interpolation"):
        native.decode_crop_resize(_jpeg(16, 16), 0, 0, 16, 16, 8, 8, False, "lanczos")
