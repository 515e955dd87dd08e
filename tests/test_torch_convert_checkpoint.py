"""Port parity: `cli/convert_checkpoint` and the msgpack writer against the
JAX package's.

* The writer (`compat/msgpack.to_bytes`, `msgpack_serialize`) gives the
  bytes of `flax.serialization.to_bytes` / `msgpack_serialize`: nested
  dicts and lists, every dtype the zoo uses (float32, float16, bfloat16 as
  a torch tensor beside flax's ml_dtypes array, int64, int32, uint8, bool),
  0-d arrays, numpy and Python scalars, strings around the str8 limit,
  array payloads on both sides of the bin8 limit, and arrays chunked above a chunk limit patched down alike in
  flax and the port.
* The CLI, for the LFQ, VQ and taming tokenizers and the LFQBert and Bert
  generators, from a `.bin` of the port's module (the original repo's
  layout, buffers included):
  - `.bin` -> `.msgpack` writes the bytes the JAX CLI writes from the same
    file, and prints the same line;
  - `.msgpack` -> `.bin` writes the JAX CLI's state dict key for key (in
    order), dtype for dtype and value for value, the LFQ buffers rebuilt
    under `--codebook-size`. The one stated difference: taming's mid
    block, which the port names as CompVis does (`mid.block_1`) and the
    JAX exporter as `mid.block.1`;
  - the `.bin` it writes loads strictly into the port's module and equals
    the original bit for bit.
"""

import flax.serialization as flax_serialization
import ml_dtypes
import numpy as np
import pytest
import torch

from maskbit_tpu.cli import convert_checkpoint as jax_cli
from maskbit_tpu_torch.cli import convert_checkpoint as cli
from maskbit_tpu_torch.cli.common import build_module, random_init_
from maskbit_tpu_torch.compat import msgpack
from maskbit_tpu_torch.core.checkpoint import load_pretrained, save_pretrained
from maskbit_tpu_torch.models.generator import make_generator
from maskbit_tpu_torch.models.taming import OriginalVQModel
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from tests.test_cli_eval_demo import TINY_MLM, TINY_VQ

torch.set_num_threads(2)


def _zoo_tree():
    rng = np.random.default_rng(0)
    bf16 = rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16)
    tree = {
        "params": {
            "encoder": {"conv_in": {"kernel": rng.normal(size=(3, 3, 3, 8)).astype(np.float32),
                                    "bias": np.zeros(8, np.float32)},
                        "norm": {"scale": np.ones(8, np.float16)}},
            "tok_emb_0": {"embedding": rng.normal(size=(9, 4)).astype(np.float32).T},
            "bf16": bf16,
        },
        "buffers": {"bits_to_indices": np.arange(14, dtype=np.int32),
                    "step": np.array(7, np.int64), "mask": rng.random((4, 4)) < 0.5,
                    "bytes": np.arange(200, dtype=np.uint8),
                    "bin8_edge": np.arange(255, dtype=np.uint8),
                    "bin16_edge": np.arange(256, dtype=np.uint8)},
        "meta": {"name": "x" * 31, "longer": "y" * 300, "count": 70000,
                 "neg": -129, "rate": 0.1, "flag": True,
                 "np_scalar": np.float32(2.5), "list": [1, np.zeros((2,), np.float32)]},
    }
    port_tree = dict(tree, params=dict(
        tree["params"], bf16=torch.from_numpy(bf16.view(np.int16).copy()).view(torch.bfloat16)))
    return tree, port_tree


def test_msgpack_writer_matches_flax_bytes():
    tree, port_tree = _zoo_tree()
    want = flax_serialization.to_bytes(tree)
    assert msgpack.to_bytes(port_tree) == want
    assert msgpack.to_bytes(tree) == want
    assert msgpack.msgpack_serialize(tree) == flax_serialization.msgpack_serialize(tree)
    back = msgpack.msgpack_restore(want)
    np.testing.assert_array_equal(back["buffers"]["bits_to_indices"], np.arange(14))
    np.testing.assert_array_equal(back["params"]["bf16"], tree["params"]["bf16"].astype(np.float32))


def test_msgpack_writer_chunks_as_flax(monkeypatch, tmp_path):
    """Arrays above the chunk limit become `__msgpack_chunked_array__`
    nodes (the root, dict values; not list items), as flax cuts them; the
    reader joins them again."""
    monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"w": {"kernel": rng.normal(size=(10, 7)).astype(np.float32), "small": np.ones(4)},
            "h": np.arange(33, dtype=np.int16), "l": [np.arange(40, dtype=np.float32)]}
    want = flax_serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in want
    assert msgpack.to_bytes(tree) == want
    root = rng.normal(size=(50,)).astype(np.float32)
    assert msgpack.msgpack_serialize(root) == flax_serialization.msgpack_serialize(root)
    path = str(tmp_path / "t.msgpack")
    msgpack.write_msgpack(path, tree)
    assert open(path, "rb").read() == want
    np.testing.assert_array_equal(msgpack.read_msgpack(path)["w"]["kernel"], tree["w"]["kernel"])


VQ = dict(TINY_VQ, quantizer_type="lookup", codebook_size=32, token_size=16)
TAMING = dict(hidden_channels=32, channel_mult=[1, 2], num_res_blocks=1, attn_resolutions=[16],
              resolution=32, z_channels=32, codebook_size=32, token_size=16)
KINDS = {
    "lfq": (lambda: ConvVQModel.from_config(TINY_VQ), ["--codebook-size", "16"]),
    "vq": (lambda: ConvVQModel.from_config(VQ), []),
    "taming": (lambda: OriginalVQModel.from_config(TAMING), []),
    # 4 bits in 8 outputs is 2 splits of 2 bits or 4 of 1: the tiny config
    # needs the flag, as the JAX exporter says
    "lfq_bert": (lambda: make_generator("lfq_bert", TINY_MLM, TINY_VQ),
                 ["--codebook-splits", "2"]),
    "bert": (lambda: make_generator("bert", TINY_MLM, TINY_VQ), []),
}


def _jax_key(key: str) -> str:
    """The JAX exporter's name for a taming mid-block key."""
    for name in ("block_1", "attn_1", "block_2"):
        key = key.replace(f"mid.{name}.", f"mid.{name.replace('_', '.')}.")
    return key


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_convert_checkpoint_both_ways_matches_jax_cli(kind, tmp_path, capsys):
    ctor, export_flags = KINDS[kind]
    model = build_module(ctor, "cpu")
    random_init_(model, torch.Generator().manual_seed(5))
    source = str(tmp_path / "model.bin")
    save_pretrained(model, source)

    jax_cli.main(["--input", source, "--output", str(tmp_path / "jax.msgpack")])
    cli.main(["--input", source, "--output", str(tmp_path / "port.msgpack")])
    jax_line, port_line = capsys.readouterr().out.strip().splitlines()
    assert port_line == jax_line.replace("jax.msgpack", "port.msgpack")
    want_bytes = (tmp_path / "jax.msgpack").read_bytes()
    assert (tmp_path / "port.msgpack").read_bytes() == want_bytes

    zoo = str(tmp_path / "jax.msgpack")
    jax_cli.main(["--input", zoo, "--output", str(tmp_path / "jax.bin")] + export_flags)
    cli.main(["--input", zoo, "--output", str(tmp_path / "port.bin")] + export_flags)
    jax_line, port_line = capsys.readouterr().out.strip().splitlines()
    assert port_line == jax_line.replace("jax.bin", "port.bin")
    want = torch.load(tmp_path / "jax.bin", weights_only=True)
    got = torch.load(tmp_path / "port.bin", weights_only=True)
    assert [_jax_key(k) for k in got] == list(want)
    if kind == "taming":
        assert "encoder.mid.block_1.conv1.weight" in got
    for key, value in got.items():
        expected = want[_jax_key(key)]
        assert value.dtype == expected.dtype, key
        torch.testing.assert_close(value, expected, atol=0, rtol=0)

    again = build_module(ctor, "cpu")
    again.load_state_dict(load_pretrained(str(tmp_path / "port.bin")), strict=True)
    for key, value in model.state_dict().items():
        torch.testing.assert_close(again.state_dict()[key], value, atol=0, rtol=0)
