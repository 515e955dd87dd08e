"""Port parity: the pretokenize CLI against the JAX package's, on the CPU.

A tiny LFQ tokenizer's JAX weights are exported (`compat/torch_export.py`)
to one `.bin` that both CLIs load. Both read the same tar shards (written
by the port's shard writer from seeded numpy images) with the same
transform and write token shards. Float32 on both sides; the tolerance of
`tests/test_torch_tokenizer_encode.py`: labels and shapes exactly, tokens
exactly wherever no latent lies within 1e-4 of the sign boundary (the two
frameworks' convolutions sum in other orders), and those positions are at
least 90% of the tokens.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from maskbit_tpu.cli.pretokenize import main as jax_main
from maskbit_tpu.compat.torch_export import export_tokenizer_state, save_torch_state_dict
from maskbit_tpu.data.tar_reader import TarImageDataset, batched
from maskbit_tpu.data.transforms import EvalTransform, TrainTransform
from maskbit_tpu.models.tokenizer import ConvVQModel as JaxConvVQModel
from maskbit_tpu_torch.cli.common import build_module, random_init_
from maskbit_tpu_torch.cli.pretokenize import main as port_main
from maskbit_tpu_torch.cli.pretokenize import tokenize_to_shards
from maskbit_tpu_torch.data.shard_writer import ShardWriter
from maskbit_tpu_torch.data.token_shards import TokenShardDataset, TokenShardWriter
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from tests.test_cli_eval_demo import TINY_VQ

torch.set_num_threads(2)
RES, N = 32, 10


def _setup(tmp_path, train_augmentation):
    rng = np.random.default_rng(0)
    writer = ShardWriter(str(tmp_path / "img-%04d.tar"), maxcount=6)
    for i in range(N):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (36 + i, 40, 3), dtype=np.uint8)).save(buf, "JPEG")
        writer.write(f"{i:06d}", buf.getvalue(), i % 4)
    writer.close()
    jmodel = JaxConvVQModel.from_config(TINY_VQ)
    variables = jmodel.init(jax.random.key(3), jnp.zeros((1, RES, RES, 3)))
    ckpt = str(tmp_path / "tok.bin")
    save_torch_state_dict(export_tokenizer_state(jax.tree.map(np.asarray, variables),
                                                 TINY_VQ["codebook_size"]), ckpt)

    def config(name):
        cfg = {"experiment": {"name": name, "vqgan_checkpoint": ckpt},
               "model": {"vq_model": TINY_VQ},
               "dataset": {"params": {}, "preprocessing": {"resolution": RES,
                                                           "interpolation": "bilinear"}},
               "training": {"mixed_precision": "no", "seed": 0},
               "pretokenize": {"shards": str(tmp_path / "img-{0000..0001}.tar"),
                               "output": str(tmp_path / name / "t-%04d.npz"), "batch_size": 4,
                               "shard_size": 8, "train_augmentation": train_augmentation,
                               "device": "cpu"}}
        path = tmp_path / f"{name}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        return str(path)

    return jmodel, variables, config


def _read(pattern):
    ds = TokenShardDataset(pattern, resample=False)
    return next(ds.batches(100, drop_last=False))


@pytest.mark.parametrize("train_augmentation", [False, True])
def test_pretokenize_cli_matches_jax(tmp_path, monkeypatch, train_augmentation):
    monkeypatch.setenv("WORKSPACE", str(tmp_path / "ws"))
    jmodel, variables, config = _setup(tmp_path, train_augmentation)
    assert jax_main([f"config={config('jax')}"]) == N
    assert port_main([f"config={config('port')}"]) == N
    want, got = _read(str(tmp_path / "jax" / "t-{0000..0001}.npz")), \
        _read(str(tmp_path / "port" / "t-{0000..0001}.npz"))
    assert (tmp_path / "port" / "t-0001.npz").exists()  # shard_size 8: two shards
    np.testing.assert_array_equal(got["class_id"], want["class_id"])
    assert got["tokens"].shape == want["tokens"].shape == (N, (RES // 2) ** 2)

    # the latents of the images both CLIs tokenized decide which tokens are clear
    transform = (TrainTransform(RES, use_aspect_ratio_aug=False, interpolation="bilinear", seed=0)
                 if train_augmentation else EvalTransform(RES, "bilinear"))
    images = next(batched(iter(TarImageDataset(str(tmp_path / "img-{0000..0001}.tar"), transform,
                                               resample=False)), N))["image"]
    z = np.asarray(jmodel.apply(variables, jnp.asarray(images), method=lambda m, x: m.encoder(x)))
    clear = (np.abs(z.reshape(N, -1, 4)) > 1e-4).all(-1)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got["tokens"][clear], want["tokens"][clear])


def test_tokenize_to_shards_stops_at_max_samples(tmp_path):
    model = build_module(lambda: ConvVQModel.from_config(TINY_VQ), "cpu")
    random_init_(model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batches = ({"image": rng.uniform(size=(3, RES, RES, 3)).astype(np.float32),
                "class_id": np.arange(3, dtype=np.int32) + i} for i in range(10))
    writer = TokenShardWriter(str(tmp_path / "t-%04d.npz"))
    assert tokenize_to_shards(model, batches, writer, "cpu", max_samples=5) == 6
    out = _read(str(tmp_path / "t-0000.npz"))
    assert out["tokens"].shape == (6, (RES // 2) ** 2) and out["tokens"].max() < 16
    np.testing.assert_array_equal(out["class_id"], [0, 1, 2, 1, 2, 3])
