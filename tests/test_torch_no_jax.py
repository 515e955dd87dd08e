"""The port never imports JAX or Flax, and of the JAX package only the two
modules that import neither (`core.config`, yaml only, and
`compat.torch_export`, numpy only): a fresh interpreter imports every module
of `maskbit_tpu_torch`, serves a tiny model on CPU and then finds nothing
else of them in `sys.modules`."""

import os
import subprocess
import sys

import yaml

from tests.test_cli_eval_demo import DATASET, TINY_MLM, TINY_VQ

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
import torch
torch.set_num_threads(2)
import maskbit_tpu_torch
for m in pkgutil.walk_packages(maskbit_tpu_torch.__path__, "maskbit_tpu_torch."):
    importlib.import_module(m.name)
from maskbit_tpu.core.config import load_config
from maskbit_tpu.compat import torch_export
from maskbit_tpu_torch.cli.serve import GeneratorService
service = GeneratorService(load_config(sys.argv[1]))
images = service.generate([1, 2, 3], seed=4)
assert images.shape == (3, 32, 32, 3), images.shape
allowed = {"maskbit_tpu", "maskbit_tpu.core", "maskbit_tpu.core.config",
           "maskbit_tpu.compat", "maskbit_tpu.compat.torch_export"}
bad = sorted(m for m in sys.modules if m not in allowed
             and m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "maskbit_tpu"))
print("FORBIDDEN", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax(tmp_path):
    cfg = {
        "experiment": {"vqgan_checkpoint": "", "generator_checkpoint": ""},
        "model": {"vq_model": TINY_VQ, "mlm_model": dict(TINY_MLM, attention_impl="fused")},
        "dataset": DATASET,
        "training": {"mixed_precision": "no", "seed": 0},
        "serve": {"batch_size": 2, "device": "cpu"},
    }
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(path)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FORBIDDEN []" in proc.stdout
