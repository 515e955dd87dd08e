"""One rank of the port's data-parallel CPU tests (`tests/test_torch_distributed.py`).

    RANK=r WORLD_SIZE=n LOCAL_RANK=r LOCAL_WORLD_SIZE=n MASTER_ADDR=localhost \
    MASTER_PORT=p python tests/torch_distributed_worker.py SCENARIO WORKDIR [ARGS...]

Imports torch and `maskbit_tpu_torch`, never JAX: the test process runs the
JAX side and hands each rank its inputs through files in WORKDIR; each rank
writes `{scenario}_rank{r}.pt` (or `.json`) back. The process group is
joined through the port's own `maybe_init_distributed` (gloo on the CPU).
Scenarios:
  stage2          Stage-II steps from tokens with injected global draws;
  stage2_draws    the CLI's step stream (un-injected) draws per rank;
  stage1 MODE     Stage-I steps; MODE "global", or "local" with the entropy
                  and LeCam means left rank-local (the defect the test must
                  catch);
  train_cli ARGS  `cli.train_maskbit.main(ARGS)`;
  train_tokenizer_cli ARGS  `cli.train_tokenizer.main(ARGS)`;
  eval_maskbit ARGS  `cli.eval_maskbit.main(ARGS)` with a stand-in Inception;
  eval_tokenizer ARGS  `cli.eval_tokenizer.main(ARGS)`, recording the shards
                  each rank reads.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from maskbit_tpu_torch.parallel import mesh  # noqa: E402

torch.set_num_threads(1)


def _out(workdir, scenario):
    return os.path.join(workdir, f"{scenario}_rank{mesh.process_index()}")


def _param_digest(*modules_or_tensors):
    """float64 sums of every parameter (and of its square): equal bits on
    every rank when the ranks hold equal parameters."""
    tensors = []
    for m in modules_or_tensors:
        tensors += list(m.parameters()) if hasattr(m, "parameters") else list(m)
    return np.asarray([v for t in tensors
                       for v in (t.double().sum().item(), t.double().pow(2).sum().item())])


def stage2(workdir):
    from maskbit_tpu_torch.losses.mlm import MLMLossConfig
    from maskbit_tpu_torch.models.generator import LFQBert
    from maskbit_tpu_torch.train.generator_trainer import (
        init_generator_train_state,
        make_generator_train_step_from_tokens,
    )
    from maskbit_tpu_torch.train.optim import make_optimizer
    from maskbit_tpu_torch.utils.lr_schedules import get_schedule

    mesh.maybe_init_distributed(torch.device("cpu"))
    inp = torch.load(os.path.join(workdir, "stage2_in.pt"), weights_only=False)
    out = {}
    for remat in (False, True):
        model = LFQBert.from_config(dict(inp["mlm"], remat=remat), inp["vq"])
        model.load_state_dict(inp["state"], strict=True)
        opt = make_optimizer(model.parameters(), get_schedule(**inp["schedule"]), **inp["opt"])
        state = init_generator_train_state(model, opt)
        step = make_generator_train_step_from_tokens(
            model, inp["vq"]["codebook_size"], MLMLossConfig(), "arccos", 0.1, inp["ema"])
        history = []
        for tokens, labels, injected in zip(inp["tokens"], inp["labels"], inp["injected"]):
            b = tokens.shape[0] // mesh.process_count()
            state, metrics = step(state, torch.from_numpy(mesh.local_rows(tokens, b)),
                                  torch.from_numpy(mesh.local_rows(labels, b)), injected=injected)
            history.append({k: float(v) for k, v in metrics.items() if not k.startswith("_")})
        out["remat" if remat else "plain"] = {
            "history": history,
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "ema": {n: t.clone() for n, t in state.ema.params.items()},
            "digests": mesh.process_allgather_f64(_param_digest(model, state.ema.params.values())),
        }
    torch.save(out, _out(workdir, "stage2") + ".pt")


def stage2_draws(workdir, config):
    """The masks and attention seeds the CLI's step stream gives this rank."""
    from maskbit_tpu_torch.cli import train_maskbit
    from maskbit_tpu_torch.core.config import config_from_cli
    from maskbit_tpu_torch.nn.transformer import DropoutRng
    from maskbit_tpu_torch.ops.masking import get_mask_tokens

    run = train_maskbit.build_training(config_from_cli([f"config={config}"]),
                                       train_maskbit._logger())
    tokens = torch.zeros((4, 16), dtype=torch.int64)
    _, masks = get_mask_tokens(tokens, 99, generator=run["rng"])
    seeds = DropoutRng(run["rng"]).attention_seeds(4, 2, "cpu")
    batch = next(run["train_iter"])
    torch.save({"masks": masks, "seeds": seeds, "tokens": batch["tokens"],
                "rank": mesh.process_index(), "world": mesh.process_count()},
               _out(workdir, "stage2_draws") + ".pt")


def stage1(workdir, mode):
    import maskbit_tpu_torch.losses.vqgan as vqgan
    import maskbit_tpu_torch.ops.entropy as entropy
    from maskbit_tpu_torch.losses.vqgan import VQGANLossConfig
    from maskbit_tpu_torch.models.tokenizer import ConvVQModel
    from maskbit_tpu_torch.nn.discriminator import create_discriminator
    from maskbit_tpu_torch.train.optim import make_optimizer
    from maskbit_tpu_torch.train.tokenizer_trainer import (
        init_tokenizer_train_state,
        make_tokenizer_train_step,
    )
    from maskbit_tpu_torch.utils.lr_schedules import get_schedule

    if mode == "local":  # each rank's own batch in the entropy and LeCam means
        entropy.all_reduce_mean_ = lambda tensors: list(tensors)
        entropy.global_mean = vqgan.global_mean = lambda x: x
    mesh.maybe_init_distributed(torch.device("cpu"))
    inp = torch.load(os.path.join(workdir, "stage1_in.pt"), weights_only=False)
    model = ConvVQModel.from_config(inp["vq"])
    model.load_state_dict(inp["gen_state"], strict=True)
    disc = create_discriminator(inp["disc"])
    disc.load_state_dict(inp["disc_state"], strict=True)
    name, lr, kw = inp["schedule"]
    gen_opt = make_optimizer(model.parameters(), get_schedule(name, lr, **kw), epsilon=inp["eps"])
    disc_opt = make_optimizer(disc.parameters(), get_schedule(name, lr, **kw), epsilon=inp["eps"])
    state = init_tokenizer_train_state(model, disc, gen_opt, disc_opt)
    step = make_tokenizer_train_step(model, disc, VQGANLossConfig(**inp["losses"]),
                                     ema_kwargs={"decay": 0.999})
    history, agree = [], []
    for images in inp["images"]:
        b = images.shape[0] // mesh.process_count()
        state, metrics = step(state, torch.from_numpy(mesh.local_rows(images, b)))
        history.append({k: float(v) for k, v in metrics.items()})
        digest = _param_digest(model, disc, state.ema.params.values(), state.lecam)
        gathered = mesh.process_allgather_f64(digest)
        agree.append(bool((gathered == gathered[0]).all()))
    torch.save({"history": history, "agree": agree,
                "gen": {k: v.clone() for k, v in model.state_dict().items()},
                "disc": {k: v.clone() for k, v in disc.state_dict().items()},
                "ema": {k: v.clone() for k, v in state.ema.params.items()},
                "lecam": [t.item() for t in state.lecam]},
               _out(workdir, f"stage1_{mode}") + ".pt")


def train_cli(workdir, argv):
    from maskbit_tpu_torch.cli import train_maskbit

    result = train_maskbit.main(argv)
    with open(_out(workdir, "train_cli") + ".json", "w") as f:
        json.dump({k: result[k] for k in ("steps", "resumed_from")}, f)


def train_tokenizer_cli(workdir, argv):
    from maskbit_tpu_torch.cli import train_tokenizer

    result = train_tokenizer.main(argv)
    with open(_out(workdir, "train_tokenizer_cli") + ".json", "w") as f:
        json.dump({k: result[k] for k in ("steps", "resumed_from", "evals")}, f)


def _stub_inception(images_255):
    """A fixed function of the pixels with Inception's outputs: 2048
    features and 1008 logits, float64."""
    x = images_255.double().reshape(images_255.shape[0], -1) / 255.0
    gen = torch.Generator().manual_seed(5)
    w = torch.randn(x.shape[1], 2048 + 1008, generator=gen, dtype=torch.float64) / 8.0
    y = x @ w
    return {"2048": torch.tanh(y[:, :2048]), "logits_unbiased": y[:, 2048:]}


def eval_maskbit(workdir, argv):
    from maskbit_tpu_torch.cli import eval_maskbit as em

    seen = {"features": [], "labels": []}
    real_make_sampler = em.make_sampler

    def make_sampler(*args, **kwargs):
        sampler = real_make_sampler(*args, **kwargs)

        def recording(labels, rng):
            seen["labels"].append(labels.clone())
            return sampler(labels, rng)

        return recording

    def inception(images_255):
        feats = _stub_inception(images_255)
        seen["features"].append(feats["2048"])
        return feats

    em.make_sampler = make_sampler
    em.make_inception_fn = lambda device: inception
    result = em.main(argv)
    acc = result["accumulator"]
    n = result["local_samples"]
    torch.save({"features": torch.cat(seen["features"])[:n].numpy(),
                "labels": torch.cat(seen["labels"])[:n].numpy(), "count": result["count"],
                "act_sum": acc.act_sum, "act_outer": acc.act_outer,
                "split_count": acc.split_count, "results": result["results"]},
               _out(workdir, "eval_maskbit") + ".pt")


def eval_tokenizer(workdir, argv):
    from maskbit_tpu_torch.cli import eval_tokenizer as et
    from maskbit_tpu_torch.data import tar_reader

    read = []
    real = tar_reader.iterate_tar_samples

    def recording(path):
        read.append(os.path.basename(path))
        return real(path)

    tar_reader.iterate_tar_samples = recording
    results = et.main(argv)
    with open(_out(workdir, "eval_tokenizer") + ".json", "w") as f:
        json.dump({"results": results, "shards": read}, f)


if __name__ == "__main__":
    scenario, workdir, *rest = sys.argv[1:]
    if scenario in ("train_cli", "train_tokenizer_cli", "eval_maskbit", "eval_tokenizer"):
        globals()[scenario](workdir, rest)
    else:
        globals()[scenario](workdir, *rest)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
