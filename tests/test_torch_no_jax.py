"""The port never imports JAX, its ecosystem or anything of the JAX package.

* At run time: a fresh interpreter imports every module of
  `maskbit_tpu_torch`, reads a tiny config through the port's own
  `load_config`, serves a tiny model, takes one tiny train step on the
  CPU, writes image shards and pretokenizes them, resumes the train run
  from its checkpoint for one step from those token shards, trains the
  tiny tokenizer two steps (`cli.train_tokenizer`, the discriminator live
  from the second, LPIPS with the shipped lin heads and random VGG16
  weights as the perceptual loss), evaluates the tokenizer (with LPIPS) and
  the generator (`cli.eval_tokenizer`, `cli.eval_maskbit`
  with random Inception weights) and computes `cli.make_stats` over the
  image shard, and then finds no module of `jax`, `jaxlib`, `flax`, `optax`, `orbax` or `maskbit_tpu`
  in `sys.modules`.
* In the source: an AST scan of every `.py` under `maskbit_tpu_torch/` and
  of `chip_smoke.py` finds no `import maskbit_tpu...` or
  `from maskbit_tpu... import` other than of `maskbit_tpu_torch`, and no
  import of JAX's packages.
"""

import ast
import glob
import os
import subprocess
import sys

import pytest
import yaml

from tests.test_cli_eval_demo import DATASET, TINY_MLM, TINY_VQ

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "maskbit_tpu")

SCRIPT = r"""
import importlib, pkgutil, sys
import torch
torch.set_num_threads(2)
import maskbit_tpu_torch
for m in pkgutil.walk_packages(maskbit_tpu_torch.__path__, "maskbit_tpu_torch."):
    importlib.import_module(m.name)
from maskbit_tpu_torch.core.config import load_config
from maskbit_tpu_torch.cli.serve import GeneratorService
from maskbit_tpu_torch.cli.train_maskbit import main as train
service = GeneratorService(load_config(sys.argv[1]))
images = service.generate([1, 2, 3], seed=4)
assert images.shape == (3, 32, 32, 3), images.shape
result = train([f"config={sys.argv[1]}"])
assert result["steps"] == 1, result
import io, os
import numpy as np
from PIL import Image
from maskbit_tpu_torch.cli.pretokenize import main as pretokenize
from maskbit_tpu_torch.data.shard_writer import ShardWriter
work = os.path.dirname(sys.argv[1])
writer = ShardWriter(os.path.join(work, "img-%%04d.tar"))
for i in range(4):
    buf = io.BytesIO()
    Image.fromarray(np.full((40, 40, 3), 60 * i, np.uint8)).save(buf, "JPEG")
    writer.write(str(i), buf.getvalue(), i)
writer.close()
tokens = os.path.join(work, "tok-%%04d.npz")
assert pretokenize([f"config={sys.argv[1]}", f"pretokenize.shards={work}/img-0000.tar",
                    f"pretokenize.output={tokens}", "pretokenize.device=cpu"]) == 4
result = train([f"config={sys.argv[1]}", "training.max_train_steps=2",
                f"dataset.params.token_shards_path_or_url={work}/tok-0000.npz"])
assert result["resumed_from"] == 1 and result["steps"] == 2, result
from maskbit_tpu_torch.cli import eval_maskbit, eval_tokenizer, make_stats, train_tokenizer
from maskbit_tpu_torch.eval.inception import random_inception_state
from maskbit_tpu_torch.losses.lpips import random_vgg16_state
torch.save(random_vgg16_state(0), os.path.join(work, "vgg16.pth"))
os.environ["MASKBIT_VGG16_WEIGHTS"] = os.path.join(work, "vgg16.pth")
tok = train_tokenizer.main([f"config={sys.argv[1]}", "training.max_train_steps=2",
                            f"experiment.output_dir={work}/tok"])
assert tok["steps"] == 2 and tok["perceptual"], tok
assert tok["history"][-1]["discriminator_loss"] != 0.0, tok["history"]
os.environ["MASKBIT_EVAL_MAX_BATCHES"] = "1"
assert "LPIPS" in eval_tokenizer.main([f"config={sys.argv[1]}"])
torch.save(random_inception_state(0), os.path.join(work, "inception.pth"))
os.environ["MASKBIT_INCEPTION_WEIGHTS"] = os.path.join(work, "inception.pth")
gen = eval_maskbit.main([f"config={sys.argv[1]}", "eval.total_samples=3", "eval.batch_size=2"])
assert gen["count"] == 3 and "InceptionScore" in gen["results"], gen
assert make_stats.main(["--shards", f"{work}/img-0000.tar", "--output", f"{work}/stats.npz",
                        "--resolution", "32", "--device", "cpu"]) == 4
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
print("FORBIDDEN", bad)
sys.exit(1 if bad else 0)
""" % (FORBIDDEN,)


def test_port_imports_no_jax(tmp_path):
    cfg = {
        "experiment": {"vqgan_checkpoint": "", "generator_checkpoint": "", "log_every": 1,
                       "output_dir": str(tmp_path / "train")},
        "model": {"vq_model": TINY_VQ,
                  "mlm_model": dict(TINY_MLM, attention_impl="fused", hidden_dim=64, heads=1,
                                    attention_dropout=0.1, fused_attention_dropout=True),
                  "discriminator": {"name": "VQGAN+Discriminator", "num_stages": 1,
                                    "hidden_channels": 32, "blur_resample": True}},
        "losses": {"perceptual_loss": "lpips", "perceptual_weight": 0.1,
                   "discriminator_start": 1, "discriminator_gradient_penalty": "adopt_weight",
                   "lecam_regularization_weight": 0.001},
        "dataset": DATASET,
        "optimizer": {"params": {"learning_rate": 1e-4}},
        "training": {"mixed_precision": "no", "seed": 0, "device": "cpu",
                     "per_device_batch_size": 2, "max_train_steps": 1},
        "serve": {"batch_size": 2, "device": "cpu"},
        "eval": {"device": "cpu"},
    }
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    env = dict(os.environ, PYTHONPATH=ROOT, WORKSPACE=str(tmp_path / "ws"))
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(path)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FORBIDDEN []" in proc.stdout
    assert (tmp_path / "train" / "model-1.bin").exists()
    assert (tmp_path / "train" / "model-2.bin").exists()
    assert (tmp_path / "tok-0000.npz").exists()


def _forbidden_imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        bad += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}" for n in names
                if n.split(".")[0] in FORBIDDEN]
    return bad


SOURCES = sorted(glob.glob(os.path.join(ROOT, "maskbit_tpu_torch", "**", "*.py"),
                           recursive=True)) + [os.path.join(ROOT, "chip_smoke.py")]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, ROOT))
def test_port_sources_import_nothing_of_jax(path):
    assert _forbidden_imports(path) == []


def test_import_scan_catches_the_jax_package(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import maskbit_tpu_torch.nn\nfrom maskbit_tpu.core import config\n"
                   "def f():\n    import jax.numpy as jnp\n")
    assert [b.split(" ")[1] for b in _forbidden_imports(str(src))] == ["maskbit_tpu.core",
                                                                        "jax.numpy"]
