"""The port's Stage-II training CLI on the CPU, at a tiny size.

Two steps through `maskbit_tpu_torch.cli.train_maskbit.main` with
`training.device=cpu`: finite logged losses, `model-2.bin` and
`ema_model-2.bin` that load strictly into the port, and whose weights give
the JAX package the same logits when read by its own `load_pretrained`
(float32, atol 1e-4 as in `tests/test_torch_generator.py`).
"""

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from maskbit_tpu.core.checkpoint import load_pretrained as jax_load_pretrained
from maskbit_tpu.models.generator import LFQBert as JaxLFQBert
from maskbit_tpu_torch.cli.train_maskbit import main
from maskbit_tpu_torch.core.checkpoint import load_pretrained
from maskbit_tpu_torch.models.generator import LFQBert
from tests.test_cli_eval_demo import DATASET, TINY_VQ

torch.set_num_threads(2)

MLM = {"model_cls": "lfq_bert", "hidden_dim": 64, "depth": 2, "heads": 1, "mlp_dim": 128,
       "dropout": 0.1, "fused_attention_dropout": True, "class_label_dropout": 0.1,
       "codebook_splits": 2, "use_prenorm": False, "img_size": 32, "input_stride": 2,
       "train_mask_schedule_strategy": "arccos"}


def _config(tmp_path):
    tree = {
        "experiment": {"name": "tiny", "log_every": 1, "vqgan_checkpoint": "",
                       "output_dir": str(tmp_path / "out")},
        "model": {"vq_model": TINY_VQ, "mlm_model": MLM},
        "losses": {"mlm": {"label_smoothing": 0.1}},
        "dataset": DATASET,
        "optimizer": {"params": {"learning_rate": 1e-3, "beta1": 0.9, "beta2": 0.96,
                                 "weight_decay": 0.045, "epsilon": 1e-8}},
        "lr_scheduler": {"scheduler": "cosine_with_minimum", "params": {"warmup_steps": 1}},
        "training": {"per_device_batch_size": 2, "mixed_precision": "no", "seed": 0,
                     "max_train_steps": 2, "max_grad_norm": 1.0, "device": "cpu"},
    }
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(tree))
    return str(path)


def test_train_cli_two_steps_on_cpu(tmp_path):
    result = main([f"config={_config(tmp_path)}"])
    out = tmp_path / "out"
    assert result["steps"] == 2 and result["output_dir"] == str(out)
    losses = [h["mlm_loss"] for h in result["history"]]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    logged = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [h["step"] for h in logged] == [1, 2] and "train/masked_fraction" in logged[0]

    cfg = dict(MLM)
    rng = np.random.default_rng(0)
    model = LFQBert.from_config(cfg, TINY_VQ).eval()
    tokens = rng.integers(0, model.mask_token + 1, size=(2, model.seq_len, 2)).astype(np.int32)
    labels = np.array([1, 2], np.int32)
    jmodel = JaxLFQBert.from_config(cfg, TINY_VQ)
    for name in ("model-2.bin", "ema_model-2.bin"):
        model.load_state_dict(load_pretrained(str(out / name)), strict=True)
        with torch.inference_mode():
            got = model(torch.from_numpy(tokens), torch.from_numpy(labels))
        want = jmodel.apply(jax_load_pretrained(str(out / name)), jnp.asarray(tokens),
                            jnp.asarray(labels))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_train_cli_refuses_what_is_not_ported(tmp_path):
    shard = tmp_path / "shard-0000.tar"
    shard.write_bytes(b"")
    cfg = _config(tmp_path)
    with pytest.raises(NotImplementedError, match="tar-shard reader"):
        main([f"config={cfg}", f"dataset.params.train_shards_path_or_url={tmp_path}/shard-{{0000..0000}}.tar"])
    with pytest.raises(NotImplementedError, match="remat"):
        main([f"config={cfg}", "model.mlm_model.remat=true"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([f"config={cfg}", "training.device=cuda"])
    assert not os.path.exists(tmp_path / "out" / "model-2.bin")


def test_profile_train_reports_phases_on_cpu(tmp_path):
    from maskbit_tpu_torch.cli.profile_train import main as profile

    lines = profile([f"config={_config(tmp_path)}"])
    text = "\n".join(lines)
    for phase in ("train/tokenize", "train/forward", "train/backward", "train/optimizer",
                  "train/ema"):
        assert phase in text
    assert lines[0].startswith("train step at batch 2 on cpu")
