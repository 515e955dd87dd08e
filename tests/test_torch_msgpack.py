"""Port parity: the pure-Python `.msgpack` reader against flax.

* `compat.msgpack.msgpack_restore` returns what
  `flax.serialization.msgpack_restore` returns, bit for bit (same keys,
  dtypes, shapes and bytes), on a tree of every wire type flax writes
  (ints of every width, floats, strings of every length class, bytes,
  None, booleans, lists, nested dicts, numpy scalars, complex numbers,
  arrays of several dtypes; bfloat16 arrays come back widened to float32,
  value for value), on a chunked array (`MAX_CHUNK_SIZE` lowered so that
  flax splits it), and on the shipped LPIPS lin heads, whose file is a
  byte-equal copy of the JAX package's.
* `core.checkpoint.load_pretrained` reads a `.msgpack` that the JAX
  package's `save_pretrained` wrote, for an LFQ and a VQ tokenizer and for
  LFQBert: the state dict loads strictly into the port's model, whose
  outputs equal JAX's within atol 1e-4 (as `tests/test_torch_vq.py`).
"""

import filecmp
import os

import flax.serialization as fs
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskbit_tpu.core.checkpoint import save_pretrained as jax_save_pretrained
from maskbit_tpu.models.generator import LFQBert as JaxLFQBert
from maskbit_tpu.models.tokenizer import ConvVQModel as JaxConvVQModel
from maskbit_tpu_torch.compat.msgpack import msgpack_restore, read_msgpack
from maskbit_tpu_torch.core.checkpoint import load_pretrained
from maskbit_tpu_torch.models.generator import LFQBert
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from tests.test_cli_eval_demo import TINY_MLM, TINY_VQ

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same(got, want, path="") -> None:
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype.name == "bfloat16":
        assert got.dtype == np.float32 and got.shape == want.shape, path
        np.testing.assert_array_equal(got, np.asarray(want, np.float32), err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def test_reader_matches_flax_on_every_type():
    rng = np.random.default_rng(0)
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1, -1, -32, -33, -128,
                 -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
        "floats": [0.0, -1.5, 1e300, float("inf")],
        "strings": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000],
        "bytes": [b"", b"\x00\xff", bytes(300), bytes(70000)],
        "misc": [None, True, False, 1 + 2j],
        "scalars": {"f32": np.float32(1.25), "i64": np.int64(-7), "bool": np.bool_(True)},
        "arrays": {"f32": rng.normal(size=(3, 4)).astype(np.float32),
                   "f16": rng.normal(size=(5,)).astype(np.float16),
                   "i8": rng.integers(-100, 100, size=(2, 2, 2)).astype(np.int8),
                   "u32": np.arange(7, dtype=np.uint32), "empty": np.zeros((0, 3), np.float32),
                   "bf16": jnp.asarray(rng.normal(size=(4, 2)), jnp.bfloat16),
                   "scalar": np.asarray(3.0, np.float64)},
        "long_list": list(range(20)),
        "wide": {f"k{i}": i for i in range(20)},
    }
    data = fs.msgpack_serialize(tree)
    want = fs.msgpack_restore(data)
    _assert_same(msgpack_restore(data), want)


def test_reader_joins_chunked_arrays(monkeypatch):
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)  # bytes: 16 float32 values a chunk
    arr = np.random.default_rng(1).normal(size=(7, 11)).astype(np.float32)
    data = fs.msgpack_serialize({"w": {"kernel": arr}, "b": np.arange(3, dtype=np.int32)})
    raw = fs.msgpack.unpackb(data, ext_hook=fs._msgpack_ext_unpack, raw=False)
    assert raw["w"]["kernel"]["__msgpack_chunked_array__"] and len(raw["w"]["kernel"]["chunks"]) > 1
    got = msgpack_restore(data)
    _assert_same(got, fs.msgpack_restore(data))
    np.testing.assert_array_equal(got["w"]["kernel"], arr)


def test_shipped_lpips_heads_are_the_jax_packages():
    ours = os.path.join(ROOT, "maskbit_tpu_torch", "assets", "vgg_lpips_lin.msgpack")
    theirs = os.path.join(ROOT, "maskbit_tpu", "assets", "vgg_lpips_lin.msgpack")
    assert os.path.getsize(ours) == 6071 and filecmp.cmp(ours, theirs, shallow=False)
    with open(theirs, "rb") as f:
        _assert_same(read_msgpack(ours), fs.msgpack_restore(f.read()))


VQ = dict(TINY_VQ, quantizer_type="lookup", codebook_size=32, token_size=16)


@pytest.mark.parametrize("cfg", [TINY_VQ, VQ], ids=["lfq", "vq"])
def test_load_pretrained_reads_a_jax_tokenizer_msgpack(tmp_path, cfg):
    jmodel = JaxConvVQModel.from_config(cfg)
    variables = jax.jit(jmodel.init)(jax.random.key(2), jnp.zeros((1, 32, 32, 3)))
    path = str(tmp_path / "tokenizer.msgpack")
    jax_save_pretrained(variables["params"], path)
    model = ConvVQModel.from_config(cfg).eval()
    model.load_state_dict(load_pretrained(path), strict=True)
    images = np.random.default_rng(3).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    want, want_dict = jax.jit(jmodel.apply)(variables, jnp.asarray(images))
    with torch.inference_mode():
        got, got_dict = model(torch.from_numpy(images))
    np.testing.assert_array_equal(got_dict["min_encoding_indices"].numpy(),
                                  np.asarray(want_dict["min_encoding_indices"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_load_pretrained_reads_a_jax_generator_msgpack(tmp_path):
    mlm = dict(TINY_MLM, codebook_splits=1)  # splits derive uniquely from the shapes
    jmodel = JaxLFQBert.from_config(mlm, TINY_VQ)
    n = (mlm["img_size"] // mlm["input_stride"]) ** 2
    tokens = np.random.default_rng(4).integers(0, 16, size=(2, n, 1)).astype(np.int32)
    labels = np.array([3, 7], np.int32)
    variables = jax.jit(jmodel.init)(jax.random.key(5), jnp.asarray(tokens), jnp.asarray(labels))
    path = str(tmp_path / "generator.msgpack")
    jax_save_pretrained(variables["params"], path)
    model = LFQBert.from_config(mlm, TINY_VQ).eval()
    model.load_state_dict(load_pretrained(path), strict=True)
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(tokens), jnp.asarray(labels))
    with torch.inference_mode():
        got = model(torch.from_numpy(tokens).long(), torch.from_numpy(labels).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
