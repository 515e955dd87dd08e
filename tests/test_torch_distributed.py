"""Multi-process runs of the port, on the CPU (gloo): the data axis, and the
fsdp and tensor axes.

Each test spawns 2 to 4 ranks of `tests/torch_distributed_worker.py`
(torch and `maskbit_tpu_torch` only, no JAX), joined through the port's
`maybe_init_distributed`; this process runs the JAX side, in one process on
the global batch, and hands the ranks their inputs through files. Each
launch has its own deadline, so a hang fails the test instead of the suite.
Tiny shapes: 2 layers, width 64, 8x8 token grids (16x16 in Stage I).

* Stage II: 2 ranks x batch 4 against JAX at batch 8 for 3 steps, the same
  injected global draws (each rank takes its rows): every metric within
  rtol 1e-5 (grad norm 1e-4), parameters and EMA within atol 2e-6 (the
  tolerances of `tests/test_torch_train_step.py`); the port's own
  one-process run at batch 8 the same way; remat on equal to remat off bit
  for bit; the ranks' parameters equal bit for bit.
* Stage-II draws without injection (the CLI's step stream, per-rank token
  shards): the ranks' masks, attention seeds and batches differ.
* Stage I: 2 ranks x batch 2 against JAX at batch 4, 4 steps across
  `discriminator_start=2`, the LFQ entropy, LeCam and the adaptive weight
  on, with the tolerances of `tests/test_torch_tokenizer_train.py`; the
  ranks' halves are dark and bright images, so a rank-local entropy or
  LeCam mean (the worker's "local" mode) misses those tolerances by 10x or
  more, which the test asserts; every rank's parameters, EMA and LeCam
  state equal after every step.
* SIGTERM to one of 2 ranks of `cli.train_maskbit`: both stop on the same
  step (a multiple of 8, the cross-process check), one collective save,
  then a resume from it on both.
* `cli.train_maskbit` on 2 ranks with `generate_every` and `eval_every`:
  one log line per step, one pair of grids, the in-training eval merged and
  logged once; `cli.train_tokenizer` on 2 ranks: its in-training eval
  merged (equal on both ranks), a collective save and a resume.
* `cli.eval_maskbit` on 3 ranks, 10 samples at batch 3 (a padded batch):
  exactly 10 scored, each global sample once with its class-balanced
  label, and the merged float64 moments equal to those of the concatenated
  per-rank features (relative 1e-12).
* `cli.eval_tokenizer` on 2 ranks over 5 shards: each rank's shards
  disjoint and covering, the merged metrics equal to one process's (rtol
  1e-5: float32 batch sums over other batches; codebook usage exactly).
* The fsdp and tensor axes (`parallel/zero.py`), 2 heads: Stage II at
  parallel.fsdp=2, at tensor=2 and at fsdp=2 x tensor=2 (2, 2 and 4 ranks)
  against JAX's one-process steps at batch 8 with the same injected
  draws, with the data axis's tolerances (metrics rtol 1e-5, grad norm
  1e-4, parameters and EMA atol 2e-6: the row-parallel layers' partial
  sums and the sharded norm add float32 reassociation only); every rank's
  gathered state equal bit for bit; each rank's dropout kernels run on
  2 / tensor heads with the keep masks of the one-process rows and heads,
  bit for bit; the stored bytes about 1 / (fsdp x tensor) of the whole
  where the rules split. Stage I at fsdp=2 (2 ranks x batch 2) against JAX
  with Stage I's tolerances. A one-process checkpoint restored on fsdp=2 x
  tensor=2 equal bit for bit, then a step and a save there restored in one
  process equal bit for bit, its `.bin` exports equal to one process's.
  `cli.train_maskbit` on 2 ranks at tensor=2 (grids and eval with the
  whole EMA weights, whole `.bin` files, then resumed by the same CLI in
  one process) and `cli.train_tokenizer` at fsdp=2 (merged eval, a save, a
  resume).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from maskbit_tpu.compat.torch_export import export_generator_state
from maskbit_tpu.losses.mlm import MLMLossConfig as JaxMLMLossConfig
from maskbit_tpu.losses.vqgan import VQGANLossConfig as JaxLossConfig
from maskbit_tpu.models.generator import LFQBert as JaxLFQBert
from maskbit_tpu.models.tokenizer import ConvVQModel as JaxConvVQModel
from maskbit_tpu.nn import discriminator as jax_disc
from maskbit_tpu.nn import pallas_attention
from maskbit_tpu.train import generator_trainer as jax_trainer
from maskbit_tpu.train import tokenizer_trainer as jax_tok_trainer
from maskbit_tpu.utils.lr_schedules import get_schedule as jax_get_schedule
from maskbit_tpu_torch.cli import eval_tokenizer
from maskbit_tpu_torch.cli.eval_maskbit import class_balanced_labels
from maskbit_tpu_torch.core.checkpoint import CheckpointManager, save_pretrained
from maskbit_tpu_torch.compat.torch_export import export_discriminator_state, export_tokenizer_state
from maskbit_tpu_torch.compat.weights import (
    discriminator_from_flax,
    generator_from_flax,
    tokenizer_from_flax,
)
from maskbit_tpu_torch.data.shard_writer import ShardWriter
from maskbit_tpu_torch.data.token_shards import TokenShardWriter
from maskbit_tpu_torch.eval.inception import random_inception_state
from maskbit_tpu_torch.losses.mlm import MLMLossConfig
from maskbit_tpu_torch.models.generator import LFQBert
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from maskbit_tpu_torch.nn.discriminator import create_discriminator
from maskbit_tpu_torch.train.generator_trainer import (
    init_generator_train_state,
    make_generator_train_step_from_tokens,
)
from maskbit_tpu_torch.train.optim import make_optimizer
from maskbit_tpu_torch.utils.lr_schedules import get_schedule
from tests.test_cli_eval_demo import TINY_VQ

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_distributed_worker.py")

VQ = dict(TINY_VQ)  # 4-bit LFQ, 2 resolutions: 16 px images give 8x8 tokens
MLM = {"model_cls": "lfq_bert", "hidden_dim": 64, "depth": 2, "heads": 1, "mlp_dim": 128,
       "dropout": 0.0, "attention_dropout": 0.1, "fused_attention_dropout": True,
       "codebook_splits": 2, "use_prenorm": False, "img_size": 16, "input_stride": 2,
       "nclass": 10, "class_label_dropout": 0.1, "train_mask_schedule_strategy": "arccos",
       "num_steps": 2, "guidance_scale": 2.0}
RES, SEQ = 16, 64
CLI_MLM = dict(MLM, hidden_dim=32, mlp_dim=64, nclass=1000)  # the entry points' labels: 1000


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(workdir, nproc, *args, env=None):
    """Start `nproc` ranks of the worker; each writes its log to WORKDIR."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(nproc),
               LOCAL_WORLD_SIZE=str(nproc), **(env or {}))
    procs = []
    for rank in range(nproc):
        log = open(os.path.join(workdir, f"log_{args[0]}_{rank}.txt"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, args[0], str(workdir), *map(str, args[1:])], cwd=REPO,
            env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)), stdout=log,
            stderr=subprocess.STDOUT))
        log.close()
    return procs


def _wait(procs, workdir, scenario, timeout):
    """Every rank exits 0 within `timeout` seconds, or all are killed."""
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{scenario}: the ranks did not finish within {timeout} s")
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(workdir, f"log_{scenario}_{rank}.txt")) as f:
                pytest.fail(f"{scenario} rank {rank} exited {p.returncode}:\n{f.read()[-6000:]}")


def _run(workdir, nproc, *args, timeout=120, env=None):
    _wait(_launch(workdir, nproc, *args, env=env), workdir, args[0], timeout)


def _load(workdir, name, rank):
    return torch.load(os.path.join(workdir, f"{name}_rank{rank}.pt"), weights_only=False)


@pytest.mark.parametrize("node,world,error", [
    pytest.param({"fsdp": 2, "tensor": 2}, 8, None, id="data-1-fsdp2-tensor2-world8"),
    pytest.param({"data": 1, "tensor": 2}, 2, None, id="data1-tensor2-world2"),
    pytest.param({"fsdp": 2}, 3, ValueError, id="fsdp2-world3-ValueError"),
    pytest.param({"data": 2}, 1, ValueError, id="node2-ValueError"),
    pytest.param({"data": -1}, 1, None, id="node3-None"),
    pytest.param(None, 1, None, id="None-None")])
def test_mesh_config_ports_the_data_axis_only(node, world, error):
    """The `parallel` node against a world of processes: fsdp and tensor are
    accepted where data x fsdp x tensor can equal it (data -1 takes the
    rest); otherwise a ValueError names the numbers."""
    from maskbit_tpu_torch.core.config import Config
    from maskbit_tpu_torch.parallel.mesh import MeshConfig

    cfg = Config({} if node is None else {"parallel": node})
    if error is None:
        mesh = MeshConfig.from_config(cfg, world=world)
        assert mesh == MeshConfig(**(node or {}))
        resolved = mesh.resolve(world)
        assert resolved.data * resolved.fsdp * resolved.tensor == world
    else:
        with pytest.raises(error, match=f"{world} processes"):
            MeshConfig.from_config(cfg, world=world)


def test_mesh_layout_is_jax_axes_order():
    """Rank (d, f, t) = (d * fsdp + f) * tensor + t, as the JAX mesh's
    device array on the 8 virtual devices; the batch shard index d * fsdp
    + f is JAX's `batch_sharding` row block."""
    from maskbit_tpu.parallel.mesh import MeshConfig as JaxMeshConfig, create_mesh
    from maskbit_tpu_torch.parallel.mesh import MeshConfig, coords_of

    for shape in ((2, 2, 2), (1, 2, 4), (4, 1, 2), (2, 4, 1)):
        jmesh = create_mesh(JaxMeshConfig(*shape))
        ids = np.vectorize(lambda d: d.id)(jmesh.devices)
        for r in range(8):
            assert ids[coords_of(r, MeshConfig(*shape))] == r, (shape, r)


def test_one_process_collectives_are_identities():
    """Outside a process group every collective leaves its input as it was
    and draws nothing."""
    from maskbit_tpu_torch.parallel import mesh

    x = torch.arange(6.0).reshape(3, 2)
    assert mesh.all_reduce_mean_([x])[0] is x and torch.equal(x, torch.arange(6.0).reshape(3, 2))
    assert mesh.global_mean(x) is x and mesh.local_rows(x, 1) is x
    assert mesh.rank_seed(7) == 7 and mesh.is_main_process() and mesh.process_count() == 1
    bits = np.asarray([np.pi, -0.0, np.nextafter(1.0, 2.0)])
    gathered = mesh.process_allgather_f64(bits)
    assert gathered.shape == (1, 3) and gathered.tobytes() == bits.tobytes()
    mesh.assert_host_agreement({"anything": 1.0})
    mesh.barrier()


# ---------------------------------------------------------------- Stage II

STEPS2, BATCH2 = 3, 8
SCHEDULE = dict(name="cosine_with_minimum", base_lr=1e-3, num_warmup_steps=1,
                num_training_steps=STEPS2, minimum_rate=0.1)
OPT = dict(beta1=0.9, beta2=0.96, weight_decay=0.045, epsilon=1e-8, max_grad_norm=1.0)
EMA = {"decay": 0.9999}


def _stage2_jax(monkeypatch, mlm=MLM):
    """JAX's three steps at the global batch; the inputs and draws."""
    rng = np.random.default_rng(0)
    depth, heads = mlm["depth"], mlm["heads"]
    seed_table = rng.integers(0, 2**32, size=(STEPS2 * depth, BATCH2, heads), dtype=np.int64)
    real = pallas_attention.dropout_attention
    calls = iter(seed_table)

    def with_table_seeds(q, k, v, seeds, rate, interpret=False):
        return real(q, k, v, jnp.asarray(next(calls).astype(np.uint32)), rate, interpret=interpret)

    monkeypatch.setattr(pallas_attention, "dropout_attention", with_table_seeds)
    jgen = JaxLFQBert.from_config(mlm, VQ)
    from maskbit_tpu.train.tokenizer_trainer import make_optimizer as jax_make_optimizer

    tx = jax_make_optimizer(jax_get_schedule(**SCHEDULE), **OPT)
    jstate = jax.jit(lambda k: jax_trainer.init_generator_train_state(jgen, tx, k))(
        jax.random.key(1))
    start = jax.tree.map(np.asarray, {"params": jstate.params})
    jstep = jax_trainer.make_generator_train_step_from_tokens(
        jgen, VQ["codebook_size"], tx, JaxMLMLossConfig(), "arccos", 0.1, EMA)
    inp = {"mlm": mlm, "vq": VQ, "schedule": SCHEDULE, "opt": OPT, "ema": EMA,
           "tokens": [], "labels": [], "injected": []}
    history = []
    for step in range(STEPS2):
        tokens = rng.integers(0, VQ["codebook_size"], size=(BATCH2, SEQ)).astype(np.int32)
        labels = rng.integers(0, 10, size=(BATCH2,)).astype(np.int32)
        key = jax.random.key(100 + step)
        rng_mask, rng_drop, _ = jax.random.split(key, 3)
        key_r, key_mask = jax.random.split(rng_mask)
        inp["injected"].append({
            "mask_ratio_uniform": np.array(jax.random.uniform(key_r, (BATCH2,))),
            "mask_token_uniform": np.array(jax.random.uniform(key_mask, (BATCH2, SEQ, 2))),
            "label_drop_uniform": np.array(jax.random.uniform(rng_drop, (BATCH2,))),
            "attention_seeds": seed_table[step * depth:(step + 1) * depth]})
        inp["tokens"].append(tokens)
        inp["labels"].append(labels)
        jstate, jm = jax.jit(lambda *a: jstep(*a))(jstate, jnp.asarray(tokens),
                                                    jnp.asarray(labels), key)
        history.append({k: float(v) for k, v in jm.items() if not k.startswith("_")})
    want = {"params": export_generator_state(jax.tree.map(np.asarray, jstate.params), 2),
            "ema": export_generator_state(jax.tree.map(np.asarray, jstate.ema.params), 2),
            "history": history}
    model = generator_from_flax(start, LFQBert.from_config(mlm, VQ))
    inp["state"] = {k: v.clone() for k, v in model.state_dict().items()}
    return inp, want


def _stage2_one_process(inp):
    model = LFQBert.from_config(inp["mlm"], VQ)
    model.load_state_dict(inp["state"], strict=True)
    opt = make_optimizer(model.parameters(), get_schedule(**SCHEDULE), **OPT)
    state = init_generator_train_state(model, opt)
    step = make_generator_train_step_from_tokens(model, VQ["codebook_size"], MLMLossConfig(),
                                                 "arccos", 0.1, EMA)
    history = []
    for tokens, labels, injected in zip(inp["tokens"], inp["labels"], inp["injected"]):
        state, m = step(state, torch.from_numpy(tokens), torch.from_numpy(labels),
                        injected=injected)
        history.append({k: float(v) for k, v in m.items() if not k.startswith("_")})
    return {"history": history, "params": dict(model.named_parameters()),
            "ema": state.ema.params}


def _assert_stage2_close(got, want, what):
    for step, (g, w) in enumerate(zip(got["history"], want["history"])):
        assert set(g) == set(w), (what, set(g) ^ set(w))
        for key in w:
            rtol = 1e-4 if key == "grad_norm" else 1e-5
            np.testing.assert_allclose(g[key], w[key], rtol=rtol, err_msg=f"{what} {step} {key}")
    for name in got["params"]:
        for part in ("params", "ema"):
            np.testing.assert_allclose(np.asarray(got[part][name].detach()),
                                       np.asarray(want[part][name]), atol=2e-6, rtol=0,
                                       err_msg=f"{what} {part} {name}")


def test_stage2_two_ranks_match_jax_and_one_process(tmp_path, monkeypatch):
    inp, want = _stage2_jax(monkeypatch)
    torch.save(inp, tmp_path / "stage2_in.pt")
    procs = _launch(tmp_path, 2, "stage2")
    one = _stage2_one_process(inp)  # meanwhile, here
    _wait(procs, tmp_path, "stage2", 150)
    ranks = [_load(tmp_path, "stage2", r) for r in range(2)]
    got = ranks[0]["plain"]
    _assert_stage2_close(got, want, "2 ranks vs JAX")
    _assert_stage2_close(one, want, "1 process vs JAX")
    one_np = {"history": one["history"],
              "params": {k: v.detach().numpy() for k, v in one["params"].items()},
              "ema": {k: v.numpy() for k, v in one["ema"].items()}}
    _assert_stage2_close(got, one_np, "2 ranks vs 1 process")
    for r in range(2):
        digests = ranks[r]["plain"]["digests"]
        assert (digests == digests[0]).all(), "the ranks' parameters differ"
        assert ranks[r]["plain"]["history"] == got["history"]  # global metrics on every rank
        for part in ("params", "ema"):  # remat under the reduction: bit for bit
            for name, value in ranks[r]["remat"][part].items():
                assert torch.equal(value, ranks[r]["plain"][part][name]), (r, part, name)


def test_stage2_uninjected_draws_differ_between_ranks(tmp_path):
    writer = TokenShardWriter(str(tmp_path / "tok-%04d.npz"), maxcount=8)
    rng = np.random.default_rng(2)
    for _ in range(2):
        writer.write_batch(rng.integers(0, 16, size=(8, SEQ)), rng.integers(0, 10, size=(8,)))
    writer.close()
    tree = {"experiment": {"name": "draws", "vqgan_checkpoint": "",
                           "output_dir": str(tmp_path / "out")},
            "model": {"vq_model": VQ, "mlm_model": MLM},
            "dataset": {"params": {"token_shards_path_or_url": str(tmp_path / "tok-*.npz")},
                        "preprocessing": {"resolution": RES}},
            "optimizer": {"params": {"learning_rate": 1e-3}},
            "training": {"per_device_batch_size": 4, "seed": 0, "device": "cpu",
                         "mixed_precision": "no"}}
    cfg = tmp_path / "draws.yaml"
    cfg.write_text(yaml.safe_dump(tree))
    _run(tmp_path, 2, "stage2_draws", cfg)
    a, b = (_load(tmp_path, "stage2_draws", r) for r in range(2))
    assert (a["world"], b["world"], a["rank"], b["rank"]) == (2, 2, 0, 1)
    assert not torch.equal(a["masks"], b["masks"])
    assert not torch.equal(a["seeds"], b["seeds"])
    assert not np.array_equal(a["tokens"], b["tokens"])


# ----------------------------------------------------------------- Stage I

STEPS1, BATCH1, RES1 = 4, 4, 32  # 16x16 tokens: the discriminator's pool needs 32 px
LFQ = dict(VQ, entropy_loss_weight=0.01, entropy_loss_temperature=0.1)
V2 = {"name": "VQGAN+Discriminator", "num_channels": 3, "num_stages": 1,
      "hidden_channels": 32, "blur_resample": True, "blur_kernel_size": 4}
PIX2PIX = {"name": "Original", "num_channels": 3, "num_stages": 2, "hidden_channels": 16}
LOSSES = dict(perceptual_loss="none", perceptual_weight=0.0, reconstruction_weight=1.0,
              discriminator_weight=0.1, discriminator_start=2,
              discriminator_gradient_penalty="adopt_weight", lecam_regularization_weight=0.1,
              entropy_annealing_steps=10, entropy_annealing_factor=1.0)
METRIC_RTOL, METRIC_ATOL, PARAM_ATOL, EPS = 1e-4, 1e-6, 2e-5, 1e-6
SCHEDULE1 = ("constant_with_warmup", 1e-3, {"num_warmup_steps": 1})


def _stage1_images():
    """Each step's global batch: the first rank's rows dark, the second's
    bright, so the two halves' code usage and logits differ."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(STEPS1):
        u = rng.uniform(size=(BATCH1, RES1, RES1, 3)).astype(np.float32)
        u[:BATCH1 // 2] *= 0.3
        u[BATCH1 // 2:] = 0.7 + 0.3 * u[BATCH1 // 2:]
        out.append(u)
    return out


def _bn_batch_stats(disc, disc_params, x):
    """Each BatchNorm's (mean, biased variance) of one train-mode call of
    the Pix2Pix discriminator on x, read off flax's updated `batch_stats`
    from zeros (the update is 0.1 x the batch's)."""
    init = disc.init(jax.random.key(0), x)["batch_stats"]
    zeros = jax.tree.map(jnp.zeros_like, init)
    _, upd = disc.apply({"params": disc_params, "batch_stats": zeros}, x, train=True,
                        mutable=["batch_stats"])
    stages, side = PIX2PIX["num_stages"], x.shape[1]
    # the rows each BatchNorm sees per channel: bn_n after n + 1 stride-2
    # convolutions, the last after a stride-1 4x4 one (one pixel less)
    sides = {f"bn_{n}": side // 2 ** (n + 1) for n in range(1, stages)}
    sides[f"bn_{stages}"] = side // 2 ** stages - 1
    return {name: (np.asarray(v["mean"], np.float64) / (1 - 0.9),
                   np.asarray(v["var"], np.float64) / (1 - 0.9), x.shape[0] * sides[name] ** 2)
            for name, v in upd["batch_stats"].items()}


def _stage1_jax(images, disc_cfg=None):
    """JAX's Stage-I steps on the global batch. With the Pix2Pix
    discriminator, the running averages torch's BatchNorm would hold after
    the same calls (each step: the reconstructions in the generator pass,
    then, from `discriminator_start` on, the real images and the
    reconstructions), from JAX's batch statistics: momentum 0.1, the
    unbiased variance."""
    name, lr, kw = SCHEDULE1
    disc_cfg = V2 if disc_cfg is None else disc_cfg
    model = JaxConvVQModel.from_config(LFQ)
    disc = jax_disc.create_discriminator(disc_cfg)
    pix2pix = disc_cfg["name"] == "Original"
    gen_tx = jax_tok_trainer.make_optimizer(jax_get_schedule(name, lr, **kw), epsilon=EPS)
    disc_tx = jax_tok_trainer.make_optimizer(jax_get_schedule(name, lr, **kw), epsilon=EPS)
    state = jax.jit(lambda key: jax_tok_trainer.init_tokenizer_train_state(
        model, disc, gen_tx, disc_tx, key, (BATCH1, RES1, RES1, 3)))(jax.random.key(0))
    start = (jax.tree.map(np.asarray, state.gen_params), jax.tree.map(np.asarray,
                                                                      state.disc_params))
    step = jax.jit(jax_tok_trainer.make_tokenizer_train_step(
        model, disc, gen_tx, disc_tx, JaxLossConfig(**LOSSES), ema_kwargs={"decay": 0.999}))
    history, running = [], {}
    for i, x in enumerate(images):
        if pix2pix:
            recon = model.apply({"params": state.gen_params}, jnp.asarray(x), train=True)[0]
            calls = [recon] + ([jnp.asarray(x), recon] if i >= LOSSES["discriminator_start"]
                               else [])
            for u in calls:
                for bn, (mean, var, n) in _bn_batch_stats(disc, state.disc_params, u).items():
                    rm, rv, seen = running.get(bn, (0.0, 1.0, 0))
                    running[bn] = (0.9 * rm + 0.1 * mean, 0.9 * rv + 0.1 * var * n / (n - 1),
                                   seen + 1)
        state, m = step(state, jnp.asarray(x), None, jax.random.key(i))
        history.append({k: float(v) for k, v in m.items()})
    taps = disc_cfg.get("blur_kernel_size")
    want_disc = export_discriminator_state(jax.tree.map(np.asarray, state.disc_params), taps)
    for bn, (rm, rv, seen) in running.items():  # bn_{n} is main.{3n}
        key = f"main.{3 * int(bn.split('_')[1])}"
        want_disc.update({f"{key}.running_mean": rm, f"{key}.running_var": rv,
                          f"{key}.num_batches_tracked": np.asarray(seen)})
    return start, {
        "history": history,
        "gen": export_tokenizer_state(jax.tree.map(np.asarray, state.gen_params),
                                      VQ["codebook_size"]),
        "ema": export_tokenizer_state(jax.tree.map(np.asarray, state.ema.params),
                                      VQ["codebook_size"]),
        "disc": want_disc,
        "lecam": [float(x) for x in state.lecam]}


def _stage1_miss(got, want) -> float:
    """The largest |got - want| over its tolerance, across every metric,
    parameter and the LeCam state: <= 1 passes."""
    worst = 0.0
    for g, w in zip(got["history"], want["history"]):
        for key in w:
            worst = max(worst, abs(g[key] - w[key]) / (METRIC_ATOL + METRIC_RTOL * abs(w[key])))
    for part in ("gen", "ema", "disc"):
        for key, value in got[part].items():
            worst = max(worst, float(np.abs(np.asarray(value, np.float64)
                                            - want[part][key]).max()) / PARAM_ATOL)
    for g, w in zip(got["lecam"], want["lecam"]):
        worst = max(worst, abs(g - w) / (1e-9 + METRIC_RTOL * abs(w)))
    return worst


def _stage1_reference(disc_cfg):
    """JAX's Stage-I steps and the inputs the ranks load."""
    images = _stage1_images()
    (gen_params, disc_params), want = _stage1_jax(images, disc_cfg)
    model = tokenizer_from_flax(gen_params, ConvVQModel.from_config(LFQ), VQ["codebook_size"])
    disc = discriminator_from_flax(disc_params, create_discriminator(disc_cfg))
    inp = {"vq": LFQ, "disc": disc_cfg, "losses": LOSSES, "schedule": SCHEDULE1, "eps": EPS,
           "images": images, "gen_state": model.state_dict(), "disc_state": disc.state_dict()}
    return inp, want


@pytest.fixture(scope="module")
def stage1_reference():
    return _stage1_reference(V2)


@pytest.fixture(scope="module")
def stage1_pix2pix_reference():
    return _stage1_reference(PIX2PIX)


@pytest.fixture(scope="module")
def stage1_runs(tmp_path_factory, stage1_reference, stage1_pix2pix_reference):
    """One launch of 2 ranks per mode: "global" (the v2 discriminator, then
    the Pix2Pix one) and "local"."""
    workdir = tmp_path_factory.mktemp("stage1")
    torch.save(stage1_reference[0], workdir / "stage1_in.pt")
    torch.save(stage1_pix2pix_reference[0], workdir / "stage1_pix2pix_in.pt")
    procs = {mode: _launch(workdir, 2, "stage1", mode) for mode in ("global", "local")}
    for p in procs.values():
        _wait(p, workdir, "stage1", 150)
    return {name: [_load(workdir, name, r) for r in range(2)]
            for name in ("stage1_global", "stage1_local", "stage1_pix2pix")}


def _assert_stage1_ranks(got, want, gate):
    for rank in got:
        assert all(rank["agree"]), rank["agree"]  # parameters, EMA, LeCam after every step
        assert [h["discriminator_factor"] for h in rank["history"]] == gate
        for key in ("gen", "disc", "ema"):
            for name, value in rank[key].items():
                assert torch.equal(value, got[0][key][name]), (key, name)
    for step, (g, w) in enumerate(zip(got[0]["history"], want["history"])):
        assert set(g) == set(w), set(g) ^ set(w)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                       err_msg=f"step {step} {key}")
    assert _stage1_miss(got[0], want) <= 1.0


def test_stage1_two_ranks_match_jax_and_rank_local_means_do_not(stage1_reference, stage1_runs):
    _, want = stage1_reference
    _assert_stage1_ranks(stage1_runs["stage1_global"], want, [0.0, 0.0, 1.0, 1.0])
    # the means taken over each rank's own rows miss JAX's global batch by far
    assert _stage1_miss(stage1_runs["stage1_local"][0], want) >= 10.0


def test_stage1_pix2pix_batchnorm_over_two_ranks_matches_jax(stage1_pix2pix_reference,
                                                            stage1_runs):
    """The Pix2Pix discriminator at data=2: its BatchNorm takes the
    statistics of both ranks' rows (one dark, one bright), so the step and
    the running averages (in `_stage1_miss`, with every buffer) equal JAX's
    one process on the global batch."""
    _, want = stage1_pix2pix_reference
    got = stage1_runs["stage1_pix2pix"]
    _assert_stage1_ranks(got, want, [0.0, 0.0, 1.0, 1.0])
    assert int(got[0]["disc"]["main.3.num_batches_tracked"]) == 1 + 1 + 3 + 3
    assert not torch.equal(got[0]["disc"]["main.3.running_var"],
                           torch.ones_like(got[0]["disc"]["main.3.running_var"]))


# ------------------------------------------------------------- train CLI

def _train_config(tmp_path, max_steps):
    tree = {"experiment": {"name": "sigterm", "log_every": 1, "vqgan_checkpoint": "",
                           "output_dir": str(tmp_path / "out"), "save_every": 100_000,
                           "generate_every": 100_000, "eval_every": 100_000},
            "model": {"vq_model": VQ, "mlm_model": CLI_MLM},
            "dataset": {"params": {"train_shards_path_or_url": "/nonexistent/{0000..0001}.tar"},
                        "preprocessing": {"resolution": RES}},
            "optimizer": {"params": {"learning_rate": 1e-3}},
            "training": {"per_device_batch_size": 2, "mixed_precision": "no", "seed": 0,
                         "max_train_steps": max_steps, "device": "cpu"}}
    path = tmp_path / f"train_{max_steps}.yaml"
    path.write_text(yaml.safe_dump(tree))
    return f"config={path}"


def _logged_steps(path):
    if not os.path.exists(path):
        return []
    steps = []
    for line in open(path):
        try:
            steps.append(json.loads(line)["step"])
        except (json.JSONDecodeError, KeyError):
            continue  # a line cut mid-write
    return steps


def test_sigterm_on_one_rank_stops_both_with_one_save_then_resumes(tmp_path):
    procs = _launch(tmp_path, 2, "train_cli", _train_config(tmp_path, 100_000))
    metrics = tmp_path / "out" / "metrics.jsonl"
    deadline = time.time() + 120
    while len(_logged_steps(metrics)) < 3:
        if any(p.poll() is not None for p in procs) or time.time() > deadline:
            for p in procs:
                p.kill()
            pytest.fail("the ranks exited or stalled before step 3")
        time.sleep(0.1)
    procs[1].send_signal(signal.SIGTERM)  # rank 1 alone
    _wait(procs, tmp_path, "train_cli", 120)
    stopped = [json.load(open(tmp_path / f"train_cli_rank{r}.json"))["steps"] for r in range(2)]
    assert stopped[0] == stopped[1] and stopped[0] % 8 == 0, stopped
    ckpt = tmp_path / "out" / "checkpoints"
    assert sorted(n for n in os.listdir(ckpt) if n.isdigit()) == [str(stopped[0])]
    assert os.listdir(ckpt).count(f"metadata-{stopped[0]}.json") == 1
    assert (tmp_path / "out" / f"model-{stopped[0]}.bin").exists()

    _run(tmp_path, 2, "train_cli", _train_config(tmp_path, stopped[0] + 2))
    for r in range(2):
        result = json.load(open(tmp_path / f"train_cli_rank{r}.json"))
        assert result == {"steps": stopped[0] + 2, "resumed_from": stopped[0]}, (r, result)
    assert _logged_steps(metrics)[-2:] == [stopped[0] + 1, stopped[0] + 2]


def test_train_maskbit_cli_two_ranks_generate_and_evaluate(tmp_path):
    """The main process alone logs and draws the grids; the in-training
    eval samples one batch on each rank and logs the merged score once."""
    weights = tmp_path / "pt_inception.pth"
    torch.save(random_inception_state(0), weights)
    argv = [_train_config(tmp_path, 2), "experiment.generate_every=2", "experiment.eval_every=2",
            "training.num_generated_images=2", "eval.num_generation_samples=4",
            "eval.generation_batch_size=2"]
    _run(tmp_path, 2, "train_cli", *argv, timeout=180,
         env={"MASKBIT_INCEPTION_WEIGHTS": str(weights), "MASKBIT_ADM_PB": ""})
    for r in range(2):
        assert json.load(open(tmp_path / f"train_cli_rank{r}.json"))["steps"] == 2
    records = [json.loads(line) for line in open(tmp_path / "out" / "metrics.jsonl")]
    assert [r["step"] for r in records if "mlm_loss" in r] == [1, 2]
    evals = [r for r in records if "eval/InceptionScore" in r]
    assert [r["step"] for r in evals] == [2] and np.isfinite(evals[0]["eval/InceptionScore"])
    assert sorted(os.listdir(tmp_path / "out" / "images")) == [
        "train_decoded-000000002.png", "train_generated-000000002.png"]


def test_train_tokenizer_cli_two_ranks_evaluate_save_and_resume(tmp_path):
    tree = {"experiment": {"name": "tok", "output_dir": str(tmp_path / "out"), "log_every": 1,
                           "save_every": 2, "eval_every": 2, "generate_every": 100},
            "model": {"vq_model": LFQ, "discriminator": V2},
            "losses": dict(LOSSES, discriminator_start=1),
            "dataset": {"params": {"train_shards_path_or_url": "/nonexistent/{0000..0001}.tar"},
                        "preprocessing": {"resolution": RES1}},
            "optimizer": {"params": {"learning_rate": 1e-3, "epsilon": EPS}},
            "training": {"per_device_batch_size": 2, "mixed_precision": "no", "seed": 0,
                         "max_train_steps": 2, "device": "cpu"},
            "eval": {"max_eval_batches": 2}}
    cfg = tmp_path / "tok.yaml"
    cfg.write_text(yaml.safe_dump(tree))
    _run(tmp_path, 2, "train_tokenizer_cli", f"config={cfg}", timeout=180)
    ranks = [json.load(open(tmp_path / f"train_tokenizer_cli_rank{r}.json")) for r in range(2)]
    assert [r["steps"] for r in ranks] == [2, 2]
    # the eval merged over the ranks (each its own synthetic eval batches)
    assert ranks[0]["evals"] == ranks[1]["evals"] and ranks[0]["evals"][0]["step"] == 2
    assert 0 < ranks[0]["evals"][0]["CodebookUsage"] <= 1
    records = [json.loads(line) for line in open(tmp_path / "out" / "metrics.jsonl")]
    assert [r["step"] for r in records if "total_loss" in r] == [1, 2]
    _run(tmp_path, 2, "train_tokenizer_cli", f"config={cfg}", "training.max_train_steps=3",
         timeout=180)
    for r in range(2):
        result = json.load(open(tmp_path / f"train_tokenizer_cli_rank{r}.json"))
        assert (result["resumed_from"], result["steps"]) == (2, 3), (r, result)


# ------------------------------------------------------------------ evals

def test_eval_maskbit_three_ranks_score_every_sample_once(tmp_path):
    total, batch, seed = 10, 3, 42
    tree = {"experiment": {"name": "gen", "vqgan_checkpoint": "", "generator_checkpoint": "",
                           "output_dir": str(tmp_path / "out")},
            "model": {"vq_model": VQ, "mlm_model": CLI_MLM},
            "dataset": {"preprocessing": {"resolution": RES}},
            "training": {"seed": seed, "mixed_precision": "no"},
            "eval": {"total_samples": total, "batch_size": batch, "device": "cpu"}}
    cfg = tmp_path / "gen.yaml"
    cfg.write_text(yaml.safe_dump(tree))
    _run(tmp_path, 3, "eval_maskbit", f"config={cfg}")
    ranks = [_load(tmp_path, "eval_maskbit", r) for r in range(3)]
    assert [len(r["labels"]) for r in ranks] == [4, 3, 3]  # rank 0 pads its second batch
    feats = np.zeros((total, 2048))
    seen = np.zeros(total, int)
    labels = class_balanced_labels(total, seed)
    for p, r in enumerate(ranks):
        idx = np.arange(len(r["labels"])) * 3 + p
        feats[idx] = r["features"]
        seen[idx] += 1
        np.testing.assert_array_equal(r["labels"], labels[idx])
        assert r["count"] == total and r["split_count"].sum() == total
    assert (seen == 1).all()
    for r in ranks:
        for got, want in ((r["act_sum"], feats.sum(0)), (r["act_outer"], feats.T @ feats)):
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
        assert r["results"] == ranks[0]["results"]


def test_eval_tokenizer_two_ranks_split_the_shards_and_merge(tmp_path):
    from PIL import Image
    import io

    rng = np.random.default_rng(0)
    writer = ShardWriter(str(tmp_path / "img-%04d.tar"), maxcount=2)
    for i in range(9):  # 5 shards: 2, 2, 2, 2, 1 images
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (20, 18, 3), dtype=np.uint8)).save(buf, "JPEG")
        writer.write(f"{i:06d}", buf.getvalue(), i % 10)
    writer.close()
    pattern = f"{tmp_path}/img-{{0000..0004}}.tar"
    tree = {"experiment": {"name": "tok", "vqgan_checkpoint": "",
                           "output_dir": str(tmp_path / "out")},
            "model": {"vq_model": VQ},
            "dataset": {"params": {"train_shards_path_or_url": pattern,
                                   "eval_shards_path_or_url": pattern,
                                   "num_workers_per_device": 1},
                        "preprocessing": {"resolution": RES}},
            "training": {"per_device_batch_size": 2, "mixed_precision": "no"},
            "eval": {"device": "cpu"}}
    cfg = tmp_path / "tok.yaml"
    cfg.write_text(yaml.safe_dump(tree))
    _run(tmp_path, 2, "eval_tokenizer", f"config={cfg}")
    ranks = [json.load(open(tmp_path / f"eval_tokenizer_rank{r}.json")) for r in range(2)]
    shards = [set(r["shards"]) for r in ranks]
    assert not shards[0] & shards[1]
    assert shards[0] | shards[1] == {f"img-{i:04d}.tar" for i in range(5)}
    one = eval_tokenizer.main([f"config={cfg}"])
    for r in ranks:
        assert set(r["results"]) == set(one)
        for key, value in one.items():
            np.testing.assert_allclose(r["results"][key], value, rtol=1e-5, err_msg=key)
        assert r["results"]["CodebookUsage"] == one["CodebookUsage"]


# -------------------------------------------------- the fsdp and tensor axes

MLM_TP = dict(MLM, heads=2)  # 2 heads of 32: one a rank under tensor=2
MLM_HEADS3 = dict(MLM, heads=3, hidden_dim=48)  # 3 heads of 16: they do not divide tensor=2


@pytest.fixture(scope="module")
def stage2_tp_reference():
    with pytest.MonkeyPatch.context() as mp:
        return _stage2_jax(mp, MLM_TP)


@pytest.fixture(scope="module")
def stage2_heads3_reference():
    with pytest.MonkeyPatch.context() as mp:
        return _stage2_jax(mp, MLM_HEADS3)


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory, stage2_tp_reference, stage2_heads3_reference):
    """`run(fsdp, tensor)`: each rank's results of one launch on that mesh,
    by input name; the tensor=2 launch also steps the 3-head model."""
    done = {}

    def run(fsdp, tensor):
        if (fsdp, tensor) not in done:
            workdir = tmp_path_factory.mktemp(f"sharded_{fsdp}_{tensor}")
            names = {"stage2_sharded": stage2_tp_reference[0]}
            if (fsdp, tensor) == (1, 2):
                names["stage2_heads3"] = stage2_heads3_reference[0]
            for name, inp in names.items():
                torch.save(inp, workdir / f"{name}_in.pt")
            world = fsdp * tensor
            _run(workdir, world, "stage2_sharded", fsdp, tensor, *names, timeout=150)
            done[fsdp, tensor] = {name: [_load(workdir, f"{name}_{fsdp}_{tensor}", r)
                                         for r in range(world)] for name in names}
        return done[fsdp, tensor]

    return run


@pytest.mark.parametrize("fsdp,tensor", [(2, 1), (1, 2), (2, 2)],
                         ids=["fsdp2", "tensor2", "fsdp2-tensor2"])
def test_stage2_sharded_ranks_match_jax(stage2_tp_reference, sharded_runs, fsdp, tensor):
    _, want = stage2_tp_reference
    ranks = sharded_runs(fsdp, tensor)["stage2_sharded"]
    got = ranks[0]
    _assert_stage2_close(got, want, f"fsdp={fsdp} tensor={tensor} vs JAX")
    calls = STEPS2 * MLM_TP["depth"]
    for r in ranks:
        assert (r["digests"] == r["digests"][0]).all(), "the ranks' gathered states differ"
        assert r["history"] == got["history"]  # the global batch's metrics on every rank
        assert r["heads_seen"] == [MLM_TP["heads"] // tensor] * calls
        assert r["masks_equal"] == [True] * calls
        assert r["split"] > 0 and r["whole_bytes"] / (fsdp * tensor) <= r["stored_bytes"]
        assert r["stored_bytes"] < 0.6 * r["whole_bytes"], (r["stored_bytes"], r["whole_bytes"])
        assert not r["warnings"]


def test_stage2_heads_not_dividing_tensor_replicate_the_layer(stage2_heads3_reference,
                                                              sharded_runs):
    """3 heads at parallel.tensor=2 (2 ranks): each attention layer runs
    whole on both ranks, as JAX runs its unpartitioned kernel, with one
    warning per layer; the feed-forward layers still split (mlp_dim 128).
    The step equals JAX's one process on the global batch with the
    tolerances of `test_stage2_sharded_ranks_match_jax`."""
    _, want = stage2_heads3_reference
    ranks = sharded_runs(1, 2)["stage2_heads3"]
    got = ranks[0]
    _assert_stage2_close(got, want, "heads=3 tensor=2 vs JAX")
    depth = MLM_HEADS3["depth"]
    calls = STEPS2 * depth
    ffn = sorted(f"transformer.layers.{i}.1.net.{k}" for i in range(depth)
                 for k in ("0.weight", "0.bias", "2.weight"))
    for r in ranks:
        assert (r["digests"] == r["digests"][0]).all(), "the ranks' gathered states differ"
        assert r["history"] == got["history"]
        assert r["heads_seen"] == [MLM_HEADS3["heads"]] * calls  # every head on every rank
        assert r["masks_equal"] == [True] * calls
        assert r["megatron"] == ffn
        for i in range(depth):  # q|k|v and out-projection: not split at fsdp=1
            for key in ("in_proj_weight", "in_proj_bias", "out_proj.weight"):
                assert f"transformer.layers.{i}.0.mha.{key}" not in r["splits"]
        assert len([w for w in r["warnings"] if "do not divide parallel.tensor=2" in w]) == depth


def test_stage1_fsdp_ranks_match_jax(tmp_path, stage1_reference):
    inp, want = stage1_reference
    torch.save(inp, tmp_path / "stage1_in.pt")
    _run(tmp_path, 2, "stage1", "fsdp", timeout=150)
    got = [_load(tmp_path, "stage1_fsdp", r) for r in range(2)]
    for rank in got:
        assert all(rank["agree"]), rank["agree"]  # the gathered states, after every step
    for step, (g, w) in enumerate(zip(got[0]["history"], want["history"])):
        assert set(g) == set(w), set(g) ^ set(w)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                       err_msg=f"step {step} {key}")
    assert _stage1_miss(got[0], want) <= 1.0
    whole = sum(v.numel() * 4 for part in ("gen", "disc") for k, v in got[0][part].items()
                if v.is_floating_point() and k in inp[f"{part}_state"])
    assert got[0]["stored_bytes"] < 0.6 * whole


@pytest.mark.parametrize("fused", [True, False], ids=["kernel-dropout", "weights-dropout"])
def test_tensor_ranks_share_the_step_stream(tmp_path, stage2_tp_reference, fused):
    """Without injected draws, the 2 ranks of a tensor group draw the
    one-process run's masks from one stream (the batch shard's): hidden
    dropout 0.1 on the whole activations, attention dropout 0.1 through
    the kernels' seeds or on the softmax weights, each rank's heads sliced
    from draws made for all heads. The port's one process with the same
    seed within the data axis's tolerances."""
    inp, _ = stage2_tp_reference
    mlm = dict(MLM_TP, dropout=0.1, fused_attention_dropout=fused)
    inp = dict(inp, mlm=mlm, seed=5, tokens=inp["tokens"][:2], labels=inp["labels"][:2])
    torch.save(inp, tmp_path / "stage2_stream_in.pt")
    procs = _launch(tmp_path, 2, "stage2_stream", 2, int(fused))
    model = LFQBert.from_config(mlm, VQ)
    model.load_state_dict(inp["state"], strict=True)
    opt = make_optimizer(model.parameters(), get_schedule(**SCHEDULE), **OPT)
    state = init_generator_train_state(model, opt)
    step = make_generator_train_step_from_tokens(model, VQ["codebook_size"], MLMLossConfig(),
                                                 "arccos", 0.1, EMA)
    rng = torch.Generator().manual_seed(5)
    history = []
    for tokens, labels in zip(inp["tokens"], inp["labels"]):
        state, m = step(state, torch.from_numpy(tokens), torch.from_numpy(labels), rng)
        history.append({k: float(v) for k, v in m.items() if not k.startswith("_")})
    _wait(procs, tmp_path, "stage2_stream", 150)
    one = {"history": history,
           "params": {k: v.detach().numpy() for k, v in model.named_parameters()},
           "ema": {k: v.numpy() for k, v in state.ema.params.items()}}
    for r in range(2):
        _assert_stage2_close(_load(tmp_path, f"stage2_stream_{int(fused)}", r), one,
                             f"tensor=2 rank {r} vs 1 process")


def test_sharded_checkpoint_resumes_in_one_process_and_back(tmp_path, stage2_tp_reference):
    inp, _ = stage2_tp_reference
    torch.save(inp, tmp_path / "checkpoint_in.pt")
    # one process: a step, then a checkpoint at step 1
    model = LFQBert.from_config(MLM_TP, VQ)
    model.load_state_dict(inp["state"], strict=True)
    opt = make_optimizer(model.parameters(), get_schedule(**SCHEDULE), **OPT)
    state = init_generator_train_state(model, opt)
    step = make_generator_train_step_from_tokens(model, VQ["codebook_size"], MLMLossConfig(),
                                                 "arccos", 0.1, EMA)
    state, _ = step(state, torch.from_numpy(inp["tokens"][0]), torch.from_numpy(inp["labels"][0]),
                    injected=inp["injected"][0])
    ckpt = CheckpointManager(str(tmp_path / "one_process"))
    ckpt.save(1, state, blocking=True)
    ckpt.close()
    _run(tmp_path, 4, "checkpoint_sharded", timeout=150)
    ranks = [_load(tmp_path, "checkpoint_sharded", r) for r in range(4)]
    for r in ranks:
        assert r["restored_step"] == 1 and r["restored_equal"]
        assert r["heads"] == [1] * MLM_TP["depth"]  # 2 heads over tensor=2
    # the sharded run's step-2 save, restored here, equals its gathered state
    fresh = LFQBert.from_config(MLM_TP, VQ)
    opt = make_optimizer(fresh.parameters(), get_schedule(**SCHEDULE), **OPT)
    back = init_generator_train_state(fresh, opt)
    assert CheckpointManager(str(tmp_path / "sharded")).restore_latest(back)[1] == 2
    mine, theirs = back.state_dict(), ranks[0]["state"]
    assert mine["step"] == theirs["step"] == 2
    for part in ("params", "ema"):
        tree = mine[part] if part == "params" else mine["ema"]["params"]
        other = theirs[part] if part == "params" else theirs["ema"]["params"]
        for name, value in tree.items():
            assert torch.equal(value, other[name]), (part, name)
    for key in ("mu", "nu"):
        for a, b in zip(mine["opt"][key], theirs["opt"][key]):
            assert torch.equal(a, b), key
    # the `.bin` exports: whole, equal to one process's export of the same state
    save_pretrained(fresh, str(tmp_path / "one_model.bin"))
    save_pretrained(fresh, str(tmp_path / "one_ema_model.bin"), params=back.ema.params)
    for name in ("model", "ema_model"):
        a = torch.load(tmp_path / f"one_{name}.bin", weights_only=True)
        b = torch.load(tmp_path / f"sharded_{name}.bin", weights_only=True)
        assert set(a) == set(b)
        for key in a:
            assert torch.equal(a[key], b[key]), (name, key)


def test_train_maskbit_cli_tensor2_generates_saves_and_resumes_in_one_process(tmp_path):
    """`cli.train_maskbit` on 2 ranks at parallel.tensor=2 (2 heads, one a
    rank): one pair of grids and one eval drawn with the whole EMA weights,
    whole `.bin` exports (they load strictly into a one-process model), and
    the checkpoint resumed by the same CLI in one process."""
    from maskbit_tpu_torch.cli import train_maskbit

    weights = tmp_path / "pt_inception.pth"
    torch.save(random_inception_state(0), weights)
    argv = [_train_config(tmp_path, 2), "model.mlm_model.heads=2", "parallel.tensor=2",
            "experiment.generate_every=2", "experiment.eval_every=2",
            "training.num_generated_images=2", "eval.num_generation_samples=4",
            "eval.generation_batch_size=2"]
    _run(tmp_path, 2, "train_cli", *argv, timeout=180,
         env={"MASKBIT_INCEPTION_WEIGHTS": str(weights), "MASKBIT_ADM_PB": ""})
    for r in range(2):
        assert json.load(open(tmp_path / f"train_cli_rank{r}.json"))["steps"] == 2
    records = [json.loads(line) for line in open(tmp_path / "out" / "metrics.jsonl")]
    assert [r["step"] for r in records if "mlm_loss" in r] == [1, 2]
    assert [r["step"] for r in records if "eval/InceptionScore" in r] == [2]
    assert sorted(os.listdir(tmp_path / "out" / "images")) == [
        "train_decoded-000000002.png", "train_generated-000000002.png"]
    for name in ("model-2.bin", "ema_model-2.bin"):
        state = torch.load(tmp_path / "out" / name, weights_only=True)
        LFQBert.from_config(dict(CLI_MLM, heads=2), VQ).load_state_dict(state, strict=True)
    result = train_maskbit.main([_train_config(tmp_path, 3), "model.mlm_model.heads=2"])
    assert (result["resumed_from"], result["steps"]) == (2, 3)


def test_train_tokenizer_cli_fsdp2_evaluates_saves_and_resumes(tmp_path):
    """`cli.train_tokenizer` on 2 ranks at parallel.fsdp=2: the eval merged
    (equal on both ranks), a save, and a resume on the same mesh."""
    tree = {"experiment": {"name": "tok", "output_dir": str(tmp_path / "out"), "log_every": 1,
                           "save_every": 2, "eval_every": 2, "generate_every": 2},
            "model": {"vq_model": LFQ, "discriminator": V2},
            "losses": dict(LOSSES, discriminator_start=1),
            "dataset": {"params": {"train_shards_path_or_url": "/nonexistent/{0000..0001}.tar"},
                        "preprocessing": {"resolution": RES1}},
            "optimizer": {"params": {"learning_rate": 1e-3, "epsilon": EPS}},
            "training": {"per_device_batch_size": 2, "mixed_precision": "no", "seed": 0,
                         "max_train_steps": 2, "device": "cpu"},
            "parallel": {"fsdp": 2},
            "eval": {"max_eval_batches": 2}}
    cfg = tmp_path / "tok.yaml"
    cfg.write_text(yaml.safe_dump(tree))
    _run(tmp_path, 2, "train_tokenizer_cli", f"config={cfg}", timeout=180)
    ranks = [json.load(open(tmp_path / f"train_tokenizer_cli_rank{r}.json")) for r in range(2)]
    assert [r["steps"] for r in ranks] == [2, 2]
    assert ranks[0]["evals"] == ranks[1]["evals"] and ranks[0]["evals"][0]["step"] == 2
    assert os.listdir(tmp_path / "out" / "images") == ["train_reconstructions-000000002.png"]
    state = torch.load(tmp_path / "out" / "ema_model-2.bin", weights_only=True)
    ConvVQModel.from_config(LFQ).load_state_dict(state, strict=True)
    _run(tmp_path, 2, "train_tokenizer_cli", f"config={cfg}", "training.max_train_steps=3",
         timeout=180)
    for r in range(2):
        result = json.load(open(tmp_path / f"train_tokenizer_cli_rank{r}.json"))
        assert (result["resumed_from"], result["steps"]) == (2, 3), (r, result)
