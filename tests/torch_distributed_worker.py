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
  stage1 MODE     Stage-I steps; MODE "global", "fsdp" (the tokenizer's and
                  the discriminator's state split over parallel.fsdp=2), or
                  "local" with the entropy and LeCam means left rank-local
                  (the defect the test must catch); "global" also runs the
                  inputs of `stage1_pix2pix_in.pt` when it exists (the
                  Pix2Pix discriminator, its BatchNorm over both ranks);
  stage2_sharded FSDP TENSOR [NAME...]  Stage-II steps on the mesh (data,
                  FSDP, TENSOR), the state in slices, with injected global
                  draws, for each NAME's inputs in turn (the models of one
                  launch may differ in heads); the whole state gathered, the
                  dropout seeds and heads each rank's kernels saw, the
                  splits, the warnings logged and each rank's stored bytes;
  stage2_stream TENSOR FUSED  Stage-II steps on parallel.tensor=TENSOR
                  drawing from the step stream (no injected draws), hidden
                  dropout on, attention dropout through the kernels' plain
                  versions (FUSED 1) or on the softmax weights (0);
  checkpoint_sharded  on parallel.fsdp=2, tensor=2: restore a one-process
                  checkpoint, one step, a save and whole `.bin` exports;
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


def _sharded_stage2(inp, fsdp, tensor):
    """The mesh, and a Stage-II state over a store of this rank's slices."""
    from maskbit_tpu_torch.losses.mlm import MLMLossConfig
    from maskbit_tpu_torch.models.generator import LFQBert
    from maskbit_tpu_torch.parallel.zero import ShardedParams
    from maskbit_tpu_torch.train.generator_trainer import (
        init_generator_train_state,
        make_generator_train_step_from_tokens,
    )
    from maskbit_tpu_torch.train.optim import make_optimizer
    from maskbit_tpu_torch.utils.lr_schedules import get_schedule

    mesh.maybe_init_distributed(torch.device("cpu"))
    mesh.init_mesh(mesh.MeshConfig(fsdp=int(fsdp), tensor=int(tensor)))
    model = LFQBert.from_config(inp["mlm"], inp["vq"])
    model.load_state_dict(inp["state"], strict=True)
    store = ShardedParams(model)
    params = store.parameters()
    opt = make_optimizer(params, get_schedule(**inp["schedule"]), norm_fn=store.norm_fn(params),
                         **inp["opt"])
    state = init_generator_train_state(model, opt, store=store)
    step = make_generator_train_step_from_tokens(
        model, inp["vq"]["codebook_size"], MLMLossConfig(), "arccos", 0.1, inp["ema"])
    return model, state, step


def _step_rows(state, step, inp, i):
    b = inp["tokens"][i].shape[0] // mesh.batch_shard_count()
    rows = lambda x: torch.from_numpy(mesh.local_rows(x, b, mesh.batch_group()))  # noqa: E731
    return step(state, rows(inp["tokens"][i]), rows(inp["labels"][i]), injected=inp["injected"][i])


def stage2_sharded(workdir, fsdp, tensor, *names):
    """Each NAME's Stage-II run on the mesh, from `{NAME}_in.pt` (default
    "stage2_sharded"), to `{NAME}_{FSDP}_{TENSOR}_rank{r}.pt`."""
    import logging

    import maskbit_tpu_torch.nn.transformer as transformer
    from maskbit_tpu_torch.nn.dropout_attention import hash_keep_mask

    seen, warnings = [], []
    real = transformer.dropout_attention

    def recording(q, k, v, seeds, rate):
        seen.append((q.shape[2], seeds.clone(), rate))
        return real(q, k, v, seeds, rate)

    class Warnings(logging.Handler):
        def emit(self, record):
            warnings.append(record.getMessage())

    logging.getLogger("maskbit_tpu_torch").addHandler(Warnings(logging.WARNING))
    transformer.dropout_attention = recording
    for name in names or ("stage2_sharded",):
        seen.clear()
        warnings.clear()
        inp = torch.load(os.path.join(workdir, f"{name}_in.pt"), weights_only=False)
        model, state, step = _sharded_stage2(inp, fsdp, tensor)
        history = []
        for i in range(len(inp["tokens"])):
            state, metrics = _step_rows(state, step, inp, i)
            history.append({k: float(v) for k, v in metrics.items() if not k.startswith("_")})
        # each call's keep masks against the one-process masks' rows and heads:
        # a layer whose heads divide the tensor size runs this rank's share,
        # any other all its heads
        tables = [t for inj in inp["injected"] for t in inj["attention_seeds"]]
        b = inp["tokens"][0].shape[0] // mesh.batch_shard_count()
        n = model.seq_len + 1
        heads_seen, masks_equal = [], []
        heads, t = inp["mlm"]["heads"], mesh.current_mesh().coord("tensor")
        h_local = heads // int(tensor) if heads % int(tensor) == 0 else heads
        first = t * h_local if h_local < heads else 0
        r = mesh.batch_shard_index()
        for (h, seeds, rate), table in zip(seen, tables):
            want = torch.as_tensor(table)[r * b:(r + 1) * b, first:first + h_local]
            heads_seen.append(h)
            masks_equal.append(bool(torch.equal(hash_keep_mask(seeds, n, rate),
                                                hash_keep_mask(want, n, rate))))
        whole = state.state_dict()
        stored = _resident_bytes(list(state.store.shards.values()) + list(model.parameters()))
        torch.save({"history": history, "params": whole["params"], "ema": whole["ema"]["params"],
                    "heads_seen": heads_seen, "masks_equal": masks_equal, "stored_bytes": stored,
                    "whole_bytes": sum(v.numel() * v.element_size()
                                       for v in whole["params"].values()),
                    "split": len(state.store.splits),
                    "megatron": sorted(k for k, s in state.store.splits.items() if s.megatron),
                    "splits": {k: s.spec for k, s in state.store.splits.items()},
                    "warnings": list(warnings),
                    "digests": mesh.process_allgather_f64(_param_digest(
                        list(whole["params"].values()) + list(whole["ema"]["params"].values())))},
                   _out(workdir, f"{name}_{fsdp}_{tensor}") + ".pt")


def stage2_stream(workdir, tensor, fused):
    inp = torch.load(os.path.join(workdir, "stage2_stream_in.pt"), weights_only=False)
    inp["mlm"] = dict(inp["mlm"], fused_attention_dropout=bool(int(fused)))
    model, state, step = _sharded_stage2(inp, 1, tensor)
    rng = torch.Generator().manual_seed(mesh.rank_seed(inp["seed"], mesh.batch_group()))
    history = []
    for tokens, labels in zip(inp["tokens"], inp["labels"]):
        state, metrics = step(state, torch.from_numpy(tokens), torch.from_numpy(labels), rng)
        history.append({k: float(v) for k, v in metrics.items() if not k.startswith("_")})
    whole = state.state_dict()
    torch.save({"history": history, "params": whole["params"], "ema": whole["ema"]["params"]},
               _out(workdir, f"stage2_stream_{fused}") + ".pt")


def checkpoint_sharded(workdir):
    from maskbit_tpu_torch.core.checkpoint import CheckpointManager, save_pretrained

    inp = torch.load(os.path.join(workdir, "checkpoint_in.pt"), weights_only=False)
    model, state, step = _sharded_stage2(inp, 2, 2)
    ckpt = CheckpointManager(os.path.join(workdir, "one_process"))
    restored = ckpt.restore_latest(state)[1]
    saved = torch.load(os.path.join(workdir, "one_process", str(restored), "state.pt"),
                       weights_only=True)
    whole = state.state_dict()
    equal = _tree_equal(whole, saved)
    state, _ = _step_rows(state, step, inp, restored)
    out = CheckpointManager(os.path.join(workdir, "sharded"))
    tree = out.save(state.step, state, blocking=True)
    out.close()
    params, ema = tree["params"], tree["ema"]["params"]
    if mesh.is_main_process():
        save_pretrained(model, os.path.join(workdir, "sharded_model.bin"), params=params)
        save_pretrained(model, os.path.join(workdir, "sharded_ema_model.bin"), params=ema)
    torch.save({"restored_step": restored, "restored_equal": equal,
                "state": state.state_dict(), "heads": [m.num_heads // m.tensor_group.size
                                                       for m in model.modules()
                                                       if getattr(m, "num_heads", None)]},
               _out(workdir, "checkpoint_sharded") + ".pt")


def _resident_bytes(tensors) -> int:
    """The bytes of the storages behind `tensors`, each storage once: a
    rank's slices and whatever its modules still hold between steps."""
    storages = {}
    for t in tensors:
        st = t.untyped_storage()
        storages[st.data_ptr()] = st.nbytes()
    return sum(storages.values())


def _tree_equal(a, b) -> bool:
    """Equal structure and values, tensors bit for bit."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tree_equal(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    return a == b


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

    if mode == "local":  # each rank's own batch in the entropy and LeCam means
        entropy.all_reduce_mean_ = lambda tensors, group=None: list(tensors)
        entropy.global_mean = vqgan.global_mean = lambda x, group=None: x
    mesh.maybe_init_distributed(torch.device("cpu"))
    if mode == "fsdp":
        mesh.init_mesh(mesh.MeshConfig(fsdp=mesh.process_count()))
    runs = [("stage1_in.pt", f"stage1_{mode}")]
    if mode == "global" and os.path.exists(os.path.join(workdir, "stage1_pix2pix_in.pt")):
        runs.append(("stage1_pix2pix_in.pt", "stage1_pix2pix"))
    for source, name in runs:
        inp = torch.load(os.path.join(workdir, source), weights_only=False)
        torch.save(_stage1_run(inp, mode), _out(workdir, name) + ".pt")


def _stage1_run(inp, mode):
    from maskbit_tpu_torch.losses.vqgan import VQGANLossConfig
    from maskbit_tpu_torch.models.tokenizer import ConvVQModel
    from maskbit_tpu_torch.nn.discriminator import create_discriminator
    from maskbit_tpu_torch.train.optim import make_optimizer
    from maskbit_tpu_torch.train.tokenizer_trainer import (
        init_tokenizer_train_state,
        make_tokenizer_train_step,
    )
    from maskbit_tpu_torch.utils.lr_schedules import get_schedule

    model = ConvVQModel.from_config(inp["vq"])
    model.load_state_dict(inp["gen_state"], strict=True)
    disc = create_discriminator(inp["disc"])
    disc.load_state_dict(inp["disc_state"], strict=True)
    name, lr, kw = inp["schedule"]
    stores = {}
    if mode == "fsdp":
        from maskbit_tpu_torch.parallel.zero import ShardedParams

        stores = {"gen_store": ShardedParams(model), "disc_store": ShardedParams(disc)}
        gen_params, disc_params = (stores[k].parameters() for k in ("gen_store", "disc_store"))
        norms = {"gen": stores["gen_store"].norm_fn(gen_params),
                 "disc": stores["disc_store"].norm_fn(disc_params)}
    else:
        gen_params, disc_params = list(model.parameters()), list(disc.parameters())
        norms = {"gen": None, "disc": None}
    gen_opt = make_optimizer(gen_params, get_schedule(name, lr, **kw), epsilon=inp["eps"],
                             norm_fn=norms["gen"])
    disc_opt = make_optimizer(disc_params, get_schedule(name, lr, **kw), epsilon=inp["eps"],
                              norm_fn=norms["disc"])
    state = init_tokenizer_train_state(model, disc, gen_opt, disc_opt, **stores)
    step = make_tokenizer_train_step(model, disc, VQGANLossConfig(**inp["losses"]),
                                     ema_kwargs={"decay": 0.999})
    history, agree = [], []
    for images in inp["images"]:
        b = images.shape[0] // mesh.process_count()
        state, metrics = step(state, torch.from_numpy(mesh.local_rows(images, b)))
        history.append({k: float(v) for k, v in metrics.items()})
        whole = state.state_dict()  # gathered from the slices under fsdp
        digest = _param_digest(whole["gen_params"].values(), whole["disc_params"].values(),
                               whole["ema"]["params"].values(), state.lecam,
                               [t.float() for t in disc.buffers()])
        gathered = mesh.process_allgather_f64(digest)
        agree.append(bool((gathered == gathered[0]).all()))
    buffers = lambda m: {k: v for k, v in m.state_dict().items()  # noqa: E731
                         if k not in dict(m.named_parameters())}
    stored = _resident_bytes([t for store in stores.values()
                              for t in list(store.shards.values()) + list(store.params.values())])
    return {"history": history, "agree": agree,
            "gen": {**buffers(model), **{k: v.clone() for k, v in whole["gen_params"].items()}},
            "disc": {**buffers(disc), **{k: v.clone() for k, v in whole["disc_params"].items()}},
            "ema": {k: v.clone() for k, v in whole["ema"]["params"].items()},
            "lecam": [t.item() for t in state.lecam], "stored_bytes": stored}


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
