"""Tokenizer reconstruction evaluation (PyTorch; one device, or one process
per device under torchrun).

    python -m maskbit_tpu_torch.cli.eval_tokenizer \\
        config=configs/tokenizer/maskbit_tokenizer_14bit.yaml \\
        experiment.vqgan_checkpoint=/path/maskbit_tokenizer_14bit.bin eval.device=cuda

Counterpart of `maskbit_tpu/cli/eval_tokenizer.py`: the tokenizer of
`model.vq_model.model_class` (`vqgan+` / `maskbit`, `maskgit` with the
legacy decoder, or `taming`, `models/taming.OriginalVQModel` with the JAX
CLI's keys and defaults; weights from `experiment.vqgan_checkpoint`, a
`.bin` (a taming one with its `loss.*` keys) or a `.msgpack`, else seeded
random weights with a warning) reconstructs the eval batches
(`dataset.params.eval_shards_path_or_url` when the train shards exist,
else the synthetic eval batches) and `TokenizerEvaluator` streams MAE, MSE,
PSNR, SSIM, codebook usage and entropy, and with Inception weights rFID and
the Inception Score. `MASKBIT_EVAL_MAX_BATCHES` caps the batches (of each
process). Across processes each evaluates its split of the eval shards
(shard i goes to process i % process_count) and the accumulators are
summed over the processes (`merge_across_hosts`); a config with
`parallel.fsdp` or `parallel.tensor` evaluates the same way, data-parallel
over every process with whole weights. The results go to
stdout and `eval/eval_results.json` under the experiment's output
directory (`cli.common.setup_experiment`), from the main process.
`eval.device` (default "cuda") names the device.

Inception weights (`make_inception_fn`): `MASKBIT_ADM_PB`, the ADM suite's
`classify_image_graph_def.pb`, takes precedence over
`MASKBIT_INCEPTION_WEIGHTS`, a pt-fid `.pth`. LPIPS (`make_lpips_fn`) is
scored when `MASKBIT_VGG16_WEIGHTS` names torchvision's VGG16 state dict;
its lin heads come from `MASKBIT_LPIPS_WEIGHTS`, by default the port's
shipped copy of the JAX package's `.msgpack`.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Callable, Optional

import torch

from maskbit_tpu_torch.cli.common import (
    build_dataloaders,
    build_module,
    compute_dtype,
    random_init_,
    setup_experiment,
)
from maskbit_tpu_torch.core.checkpoint import load_pretrained
from maskbit_tpu_torch.core.config import config_from_cli
from maskbit_tpu_torch.eval.streaming import TokenizerEvaluator
from maskbit_tpu_torch.models.taming import OriginalVQModel
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from maskbit_tpu_torch.parallel.mesh import is_main_process, process_count


def build_tokenizer(config, dtype: torch.dtype) -> torch.nn.Module:
    """vqgan+ / maskbit, maskgit (the legacy decoder), or taming (the
    CompVis VQGAN with attention)."""
    vq_cfg = config.model.vq_model
    model_class = vq_cfg.get("model_class", "vqgan+")
    if model_class in ("vqgan+", "maskbit"):
        return ConvVQModel.from_config(vq_cfg, dtype=dtype)
    if model_class == "maskgit":
        return ConvVQModel.from_config(vq_cfg, legacy=True, dtype=dtype)
    if model_class == "taming":
        return OriginalVQModel.from_config(vq_cfg, dtype=dtype)
    raise ValueError(f"Unknown tokenizer model_class {model_class!r}")


def make_inception_fn(device="cuda") -> Optional[Callable]:
    """`fn(images_0_255_nhwc) -> {'2048', 'logits_unbiased'}` on `device`
    when Inception weights are found, else None: the graph of
    MASKBIT_ADM_PB first, then the pt-fid `.pth` of MASKBIT_INCEPTION_WEIGHTS."""
    from maskbit_tpu_torch.eval.inception import inception_from_state, load_inception_params

    pb_path = os.environ.get("MASKBIT_ADM_PB", "")
    path = os.environ.get("MASKBIT_INCEPTION_WEIGHTS", "")
    if pb_path and os.path.exists(pb_path):
        from maskbit_tpu_torch.compat.tf_graphdef import extract_inception_state

        state = extract_inception_state(pb_path)
    elif path and os.path.exists(path):
        state = load_inception_params(path)
    else:
        return None
    model = inception_from_state(state, device)

    @torch.inference_mode()
    def fn(images):
        images = images if torch.is_tensor(images) else torch.from_numpy(images)
        return model(images.to(device))

    return fn


def make_lpips_fn(device="cuda") -> Optional[Callable]:
    """`fn(real, fake) -> per-image LPIPS (b, 1, 1, 1)` on `device` when both
    weight files are found (`losses.lpips.lpips_weights`), else None."""
    from maskbit_tpu_torch.losses.lpips import load_lpips, lpips_weights

    lin_path, vgg_path, missing = lpips_weights()
    if missing:
        return None
    model = load_lpips(lin_path, vgg_path, device)

    @torch.inference_mode()
    def fn(real, fake):
        return model(real.to(device), fake.to(device))

    return fn


def main(argv=None) -> dict:
    """Evaluate; returns the results (also printed and written to
    eval_results.json)."""
    config = config_from_cli(argv if argv is not None else sys.argv[1:])
    ctx = setup_experiment(config, subdir="eval")
    logger, device = ctx["logger"], ctx["device"]
    dtype = compute_dtype(config, default="no")
    model = build_module(lambda: build_tokenizer(config, dtype), device)

    ckpt_path = config.select("experiment.vqgan_checkpoint", "")
    if ckpt_path and os.path.exists(ckpt_path):
        model.load_state_dict(load_pretrained(ckpt_path, device), strict=True)
        logger.info(f"loaded tokenizer from {ckpt_path}")
    else:
        logger.warning(f"checkpoint {ckpt_path!r} missing — RANDOM weights (smoke mode)")
        random_init_(model, torch.Generator(device=device).manual_seed(0))

    inception_fn = make_inception_fn(device)
    if inception_fn is None:
        logger.warning("MASKBIT_INCEPTION_WEIGHTS not set — rFID / InceptionScore disabled")
    lpips_fn = make_lpips_fn(device)
    if lpips_fn is None:
        logger.warning("MASKBIT_LPIPS_WEIGHTS / MASKBIT_VGG16_WEIGHTS not set — LPIPS disabled")
    evaluator = TokenizerEvaluator(
        inception_fn=inception_fn,
        lpips_fn=lpips_fn,
        enable_rfid=inception_fn is not None,
        enable_inception_score=inception_fn is not None,
        enable_lpips_score=lpips_fn is not None,
        enable_psnr_score=True,
        enable_ssim_score=True,
        enable_mse_error=True,
        enable_mae_error=True,
        enable_codebook_usage_measure=True,
        enable_codebook_entropy_measure=True,
        num_codebook_entries=config.select("model.vq_model.codebook_size", 1024),
    )

    batch_size = config.select("training.per_device_batch_size", 16)
    _, make_eval, _ = build_dataloaders(config, logger, batch_size * process_count())
    max_batches = int(os.environ.get("MASKBIT_EVAL_MAX_BATCHES", "0")) or None
    with torch.inference_mode():
        for i, batch in enumerate(make_eval()):
            if max_batches and i >= max_batches:
                break
            images = torch.from_numpy(batch["image"]).to(device)
            recons, result = model(images)
            evaluator.update(images, recons.clamp(0.0, 1.0),
                             codebook_indices=result["min_encoding_indices"])
    evaluator.merge_across_hosts()

    results = evaluator.result()
    logger.info(f"EVALUATION: {results}")
    if is_main_process():
        print(json.dumps(results))
        with open(os.path.join(ctx["output_dir"], "eval_results.json"), "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
