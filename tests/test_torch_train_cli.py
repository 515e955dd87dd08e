"""The port's Stage-II training CLI on the CPU, at a tiny size.

Through `maskbit_tpu_torch.cli.train_maskbit.main` with
`training.device=cpu`:
* two steps: finite logged losses, `model-2.bin` and `ema_model-2.bin` that
  load strictly into the port, and whose weights give the JAX package the
  same logits when read by its own `load_pretrained` (float32, atol 1e-4 as
  in `tests/test_torch_generator.py`);
* three steps from token shards against the JAX package's from-tokens step
  on the same weights, batches and draws (injected as in
  `tests/test_torch_train_step.py`; hidden dropout 0, attention dropout
  0.1): per step the loss within rtol 1e-5, and the saved weights and EMA
  within atol 2e-6, that test's tolerances;
* two steps of a tiny `model_cls: bert` config, whose saved weights give
  the JAX package's Bert the same logits;
* two steps from tar shards, and two through the native JPEG decoder
  (`MASKBIT_DECODE_BACKEND=native`);
* resume from a `save_every` checkpoint, and a run stopped by SIGTERM that
  saves and from which the next run resumes (as `tests/test_preemption.py`
  does for the JAX tokenizer CLI);
* `generate_every`: the generated and decoded grids, and generation with
  the EMA weights equal to the sampler's on a model that holds them.
"""

import io
import json
import math
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from maskbit_tpu.core.checkpoint import load_pretrained as jax_load_pretrained
from maskbit_tpu.core.ema import init_ema as jax_init_ema
from maskbit_tpu.losses.mlm import MLMLossConfig as JaxMLMLossConfig
from maskbit_tpu.models.generator import LFQBert as JaxLFQBert
from maskbit_tpu.nn import pallas_attention
from maskbit_tpu.train import generator_trainer as jax_trainer
from maskbit_tpu.train.tokenizer_trainer import make_optimizer as jax_make_optimizer
from maskbit_tpu.utils.lr_schedules import get_schedule as jax_get_schedule
from maskbit_tpu_torch.cli import train_maskbit
from maskbit_tpu_torch.cli.train_maskbit import main
from maskbit_tpu_torch.core.checkpoint import load_pretrained, save_pretrained
from maskbit_tpu_torch.data.shard_writer import ShardWriter
from maskbit_tpu_torch.data.token_shards import TokenShardDataset, TokenShardWriter
from maskbit_tpu_torch.models.generator import LFQBert, init_generator_weights_
from tests.test_cli_eval_demo import DATASET, TINY_VQ

torch.set_num_threads(2)

MLM = {"model_cls": "lfq_bert", "hidden_dim": 64, "depth": 2, "heads": 1, "mlp_dim": 128,
       "dropout": 0.1, "fused_attention_dropout": True, "class_label_dropout": 0.1,
       "codebook_splits": 2, "use_prenorm": False, "img_size": 32, "input_stride": 2,
       "train_mask_schedule_strategy": "arccos"}


def _config(tmp_path, mlm=None, **sections):
    tree = {
        "experiment": {"name": "tiny", "log_every": 1, "vqgan_checkpoint": "",
                       "output_dir": str(tmp_path / "out")},
        "model": {"vq_model": TINY_VQ, "mlm_model": mlm or MLM},
        "losses": {"mlm": {"label_smoothing": 0.1}},
        "dataset": DATASET,
        "optimizer": {"params": {"learning_rate": 1e-3, "beta1": 0.9, "beta2": 0.96,
                                 "weight_decay": 0.045, "epsilon": 1e-8}},
        "lr_scheduler": {"scheduler": "cosine_with_minimum", "params": {"warmup_steps": 1}},
        "training": {"per_device_batch_size": 2, "mixed_precision": "no", "seed": 0,
                     "max_train_steps": 2, "max_grad_norm": 1.0, "device": "cpu"},
    }
    for section, values in sections.items():
        tree[section] = dict(tree[section], **values)  # the shared dicts stay as they are
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


def _image_shards(tmp_path, n=8):
    rng = np.random.default_rng(0)
    writer = ShardWriter(str(tmp_path / "img-%04d.tar"), maxcount=5)
    for i in range(n):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)).save(buf, "JPEG")
        writer.write(f"{i:06d}", buf.getvalue(), i % 10)
    writer.close()
    return f"{tmp_path}/img-{{0000..0001}}.tar"


def test_train_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """CUDA asked for without a card is refused; the native JPEG decoder,
    once refused, now trains: `MASKBIT_DECODE_BACKEND=native` takes two
    steps from JPEG shards with every image through the C++ decoder."""
    from maskbit_tpu_torch.data import tar_reader

    cfg = _config(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([f"config={cfg}", "training.device=cuda"])
        assert not os.path.exists(tmp_path / "out" / "model-2.bin")
    decoded = []
    real = tar_reader._decode_sample_native

    def counted(sample, transform, seed=None):
        out = real(sample, transform, seed)
        decoded.append(sample["__key__"])
        return out

    monkeypatch.setattr(tar_reader, "_decode_sample_native", counted)
    monkeypatch.setenv("MASKBIT_DECODE_BACKEND", "native")
    result = main([f"config={cfg}",
                   f"dataset.params.train_shards_path_or_url={_image_shards(tmp_path)}"])
    assert result["steps"] == 2
    assert all(math.isfinite(h["mlm_loss"]) for h in result["history"])
    assert len(decoded) >= 2 * 2  # two steps of batch 2, each image decoded natively
    assert os.path.exists(tmp_path / "out" / "model-2.bin")


def test_train_cli_trains_bert_on_cpu(tmp_path):
    """`model_cls: bert` through `main`: two steps with finite losses; the
    weights moved (the model's differ from its slow EMA's, which stays near
    the initial weights), and the JAX package's Bert, reading
    `model-2.bin` with its own `load_pretrained`, gives the port's logits
    (float32, atol 1e-4 as in `tests/test_torch_bert.py`)."""
    from maskbit_tpu.models.generator import Bert as JaxBert
    from maskbit_tpu_torch.models.generator import Bert

    cfg = dict(MLM, model_cls="bert")
    result = main([f"config={_config(tmp_path, mlm=cfg)}"])
    losses = [h["mlm_loss"] for h in result["history"]]
    assert result["steps"] == 2 and len(losses) == 2 and all(math.isfinite(x) for x in losses)
    out = tmp_path / "out"
    model, ema = (load_pretrained(str(out / name)) for name in ("model-2.bin", "ema_model-2.bin"))
    assert "tok_emb_list.1.weight" in model and "bias.0" in model
    assert not torch.equal(model["tok_emb_list.0.weight"], ema["tok_emb_list.0.weight"])
    bert = Bert.from_config(cfg, TINY_VQ).eval()
    bert.load_state_dict(model, strict=True)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, bert.mask_token + 1, size=(2, bert.seq_len, 2)).astype(np.int32)
    labels = np.array([3, 4], np.int32)
    with torch.inference_mode():
        got = bert(torch.from_numpy(tokens), torch.from_numpy(labels))
    want = JaxBert.from_config(cfg, TINY_VQ).apply(
        jax_load_pretrained(str(out / "model-2.bin")), jnp.asarray(tokens), jnp.asarray(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_profile_train_reports_phases_on_cpu(tmp_path):
    from maskbit_tpu_torch.cli.profile_train import main as profile

    lines = profile([f"config={_config(tmp_path)}"])
    text = "\n".join(lines)
    for phase in ("train/tokenize", "train/forward", "train/backward", "train/optimizer",
                  "train/ema"):
        assert phase in text
    assert lines[0].startswith("train step at batch 2 on cpu")


def test_profile_train_categorises_the_float32_kernels():
    """float32 runs name their cuBLAS GEMMs `sm80_xmma_gemm_*` and their
    attention kernels `attn_*_tf32_kernel`; cuDNN's convolutions carry
    `xmma` too."""
    from maskbit_tpu_torch.cli.profile_train import category_of

    assert category_of("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8").startswith(
        "cuBLAS")
    assert category_of("cutlass::Kernel2<cutlass_80_simt_sgemm_128x256_8x4_nt_align1>").startswith(
        "cuBLAS")
    assert category_of("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc").startswith(
        "tokenizer convolutions")
    assert category_of("void (anonymous namespace)::attn_fwd_tf32_kernel<64, true>(TileMaps const)"
                       ).startswith("dropout attention forward")
    assert category_of("void (anonymous namespace)::attn_bwd_tf32_kernel<64>(TileMaps const)"
                       ).startswith("dropout attention backward")
    # past head dim 128, bf16's TMA and wgmma kernels and float32's 3xTF32 ones
    assert category_of("void (anonymous namespace)::attn_fwd_wide_bf16_kernel<256, true, false, "
                       "2>(CUtensorMap_st)").startswith("dropout attention forward")
    assert category_of("void (anonymous namespace)::attn_bwd_wide_bf16_kernel<192, true, false>("
                       "CUtensorMap_st)").startswith("dropout attention backward")
    assert category_of("void (anonymous namespace)::attn_fwd_wide_tf32_kernel<256, true, false>("
                       "CUtensorMap_st)").startswith("dropout attention forward")
    assert category_of("void (anonymous namespace)::attn_bwd_wide_tf32_kernel<false, false>("
                       "CUtensorMap_st)").startswith("dropout attention backward")


def test_train_cli_trains_from_tar_shards(tmp_path):
    shards = _image_shards(tmp_path)
    cfg = _config(tmp_path, dataset={"params": {"train_shards_path_or_url": shards,
                                                "num_workers_per_device": 2,
                                                "shuffle_buffer_size": 4}})
    result = main([f"config={cfg}"])
    assert result["steps"] == 2 and all(math.isfinite(h["mlm_loss"]) for h in result["history"])


TOKEN_MLM = dict(MLM, dropout=0.0, attention_dropout=0.1)


def test_train_cli_from_token_shards_matches_jax(tmp_path, monkeypatch):
    """Three CLI steps from token shards against the JAX from-tokens step."""
    steps, batch, seed = 3, 2, 0
    seq = (32 // 2) ** 2
    rng = np.random.default_rng(1)
    writer = TokenShardWriter(str(tmp_path / "tok-%04d.npz"), maxcount=6)
    for _ in range(5):  # 6 + 4 samples in two shards
        writer.write_batch(rng.integers(0, 16, (2, seq)), rng.integers(0, 1000, (2,)))
    writer.close()
    token_shards = str(tmp_path / "tok-{0000..0001}.npz")
    cfg = _config(tmp_path, TOKEN_MLM, training={"max_train_steps": steps},
                  dataset={"params": {"token_shards_path_or_url": token_shards}},
                  experiment={"save_every": 100, "generate_every": 100})

    # the weights the CLI starts from, in the JAX package
    model = LFQBert.from_config(TOKEN_MLM, TINY_VQ)
    init_generator_weights_(model, torch.Generator().manual_seed(seed))
    save_pretrained(model, str(tmp_path / "init.bin"))
    params = jax_load_pretrained(str(tmp_path / "init.bin"))["params"]

    # the draws of the JAX steps, handed to the CLI's steps
    depth, heads = TOKEN_MLM["depth"], TOKEN_MLM["heads"]
    seed_table = rng.integers(0, 2**32, size=(steps * depth, batch, heads), dtype=np.int64)
    keys = [jax.random.key(100 + i) for i in range(steps)]
    injected = []
    for i, key in enumerate(keys):
        rng_mask, rng_drop, _ = jax.random.split(key, 3)
        key_r, key_mask = jax.random.split(rng_mask)
        injected.append({
            "mask_ratio_uniform": np.array(jax.random.uniform(key_r, (batch,))),
            "mask_token_uniform": np.array(jax.random.uniform(key_mask, (batch, seq, 2))),
            "label_drop_uniform": np.array(jax.random.uniform(rng_drop, (batch,))),
            "attention_seeds": seed_table[i * depth:(i + 1) * depth]})
    real_step = train_maskbit.make_generator_train_step_from_tokens

    def injected_step(*args, **kwargs):
        step, draws = real_step(*args, **kwargs), iter(injected)
        return lambda state, tokens, labels, gen: step(state, tokens, labels, None, next(draws))

    monkeypatch.setattr(train_maskbit, "make_generator_train_step_from_tokens", injected_step)
    result = main([f"config={cfg}"])
    assert result["steps"] == steps

    real_attention = pallas_attention.dropout_attention
    calls = iter(seed_table)
    monkeypatch.setattr(pallas_attention, "dropout_attention",
                        lambda q, k, v, seeds, rate, interpret=False: real_attention(
                            q, k, v, jnp.asarray(next(calls).astype(np.uint32)), rate,
                            interpret=interpret))
    jgen = JaxLFQBert.from_config(TOKEN_MLM, TINY_VQ)
    tx = jax_make_optimizer(jax_get_schedule("cosine_with_minimum", 1e-3, num_warmup_steps=1,
                                             num_training_steps=steps, minimum_rate=0.1),
                            beta1=0.9, beta2=0.96, weight_decay=0.045, epsilon=1e-8,
                            max_grad_norm=1.0)
    jstate = jax_trainer.GeneratorTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                             opt=tx.init(params), ema=jax_init_ema(params))
    jstep = jax_trainer.make_generator_train_step_from_tokens(
        jgen, 16, tx, JaxMLMLossConfig(label_smoothing=0.1), "arccos", 0.1, {"decay": 0.9999})
    batches = TokenShardDataset(token_shards, resample=True, seed=seed).batches(batch)
    for i, key in enumerate(keys):
        b = next(batches)
        jstate, jm = jax.jit(lambda *a: jstep(*a))(jstate, jnp.asarray(b["tokens"]),
                                                    jnp.asarray(b["class_id"]), key)
        np.testing.assert_allclose(result["history"][i]["mlm_loss"], float(jm["mlm_loss"]),
                                   rtol=1e-5)
    assert next(calls, None) is None
    out = tmp_path / "out"
    for name, tree in ((f"model-{steps}.bin", jstate.params),
                       (f"ema_model-{steps}.bin", jstate.ema.params)):
        got = jax_load_pretrained(str(out / name))["params"]
        for (path, want), have in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                      jax.tree.leaves(got), strict=True):
            np.testing.assert_allclose(np.asarray(have), np.asarray(want), atol=2e-6, rtol=0,
                                       err_msg=f"{name} {jax.tree_util.keystr(path)}")


def test_train_cli_resumes_from_save_every(tmp_path):
    cfg = _config(tmp_path, experiment={"save_every": 2, "generate_every": 100})
    first = main([f"config={cfg}", "training.max_train_steps=3"])
    ckpt_dir = tmp_path / "out" / "checkpoints"
    assert first["resumed_from"] == 0 and sorted(os.listdir(ckpt_dir)) == [
        "2", "3", "metadata-2.json", "metadata-3.json"]
    second = main([f"config={cfg}", "training.max_train_steps=5"])
    assert second["resumed_from"] == 3 and second["steps"] == 5
    assert [h["step"] for h in second["history"]] == [4, 5]
    assert all(math.isfinite(h["mlm_loss"]) for h in second["history"])
    saved = torch.load(ckpt_dir / "5" / "state.pt", weights_only=True)
    assert (saved["step"], saved["opt"]["count"], saved["ema"]["step"]) == (5, 5, 5)
    assert sorted(p for p in os.listdir(ckpt_dir) if p.startswith("metadata")) == [
        "metadata-3.json", "metadata-4.json", "metadata-5.json"]
    # nothing more to train: the run restores, saves nothing new and returns
    third = main([f"config={cfg}", "training.max_train_steps=5"])
    assert third["resumed_from"] == 5 and third["history"] == []
    assert [t.get("step") for t in third["checkpoint_timings"]] == [None]


def _logged_steps(path):
    if not os.path.exists(path):
        return []
    steps = []
    for line in open(path):
        try:
            record = json.loads(line)
        except json.JSONDecodeError:
            continue  # a line cut mid-write
        if "mlm_loss" in record:
            steps.append(record["step"])
    return steps


def test_train_cli_sigterm_saves_and_resumes(tmp_path):
    cfg = _config(tmp_path, training={"max_train_steps": 100_000, "overfit_batch": True},
                  experiment={"save_every": 100_000, "generate_every": 100_000})
    metrics = tmp_path / "out" / "metrics.jsonl"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "maskbit_tpu_torch.cli.train_maskbit", f"config={cfg}"]
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 240
        while len(_logged_steps(metrics)) < 3:
            if proc.poll() is not None:
                pytest.fail(f"the CLI exited early rc={proc.returncode}:\n"
                            f"{proc.communicate()[0][-4000:]}")
            if time.time() > deadline:
                pytest.fail("the CLI never reached 3 steps")
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-4000:]
    assert "preemption: stopping cleanly" in out
    ckpt_dir = tmp_path / "out" / "checkpoints"
    saved = max(int(p[len("metadata-"):-len(".json")]) for p in os.listdir(ckpt_dir)
                if p.startswith("metadata-"))
    trained = _logged_steps(metrics)
    # the stop comes before the step's logging: the saved step may be unlogged
    assert saved >= 3 and max(trained) <= saved <= max(trained) + 1
    assert (tmp_path / "out" / f"model-{saved}.bin").exists()

    resumed = subprocess.run(cmd + [f"training.max_train_steps={saved + 2}"], cwd=root, env=env,
                             capture_output=True, text=True, timeout=240)
    assert resumed.returncode == 0, resumed.stdout[-4000:] + resumed.stderr[-4000:]
    assert f"resumed from step {saved}" in resumed.stdout
    assert _logged_steps(metrics)[len(trained):] == [saved + 1, saved + 2]


def test_train_cli_generate_every_writes_grids(tmp_path):
    mlm = dict(MLM, num_steps=2, guidance_scale=2.0)
    cfg = _config(tmp_path, mlm, training={"max_train_steps": 4, "num_generated_images": 2},
                  experiment={"generate_every": 2, "eval_every": 2, "log_grad_norm_every": 2})
    result = main([f"config={cfg}"])
    images = tmp_path / "out" / "images"
    assert sorted(os.listdir(images)) == [f"train_{kind}-{s:09d}.png" for kind in
                                          ("decoded", "generated") for s in (2, 4)]
    # 2 samples in a row of 4; 2 pairs of [reconstruction | prediction]
    assert Image.open(images / "train_generated-000000002.png").size == (4 * 32, 32)
    assert Image.open(images / "train_decoded-000000004.png").size == (2 * 32, 2 * 32)
    logged = [json.loads(line) for line in (tmp_path / "out" / "metrics.jsonl").open()]
    norms = [r for r in logged if any(k.startswith("grad_norm/") for k in r)]
    assert [r["step"] for r in norms] == [2, 4] and len(norms[0]) == 2 + sum(
        1 for _ in LFQBert.from_config(mlm, TINY_VQ).parameters())
    assert not any(k.startswith("eval/") for r in logged for k in r)
    assert [h["step"] for h in result["history"]] == [1, 2, 3, 4]


def test_generate_uses_the_ema_weights(tmp_path):
    """`generate` samples with the EMA shadows and gives the trained weights
    back: the same images as the sampler on a model that holds the EMA."""
    from maskbit_tpu_torch.core.config import load_config

    config = load_config(_config(tmp_path, dict(MLM, num_steps=2, guidance_scale=2.0)))
    run = train_maskbit.build_training(config, train_maskbit._logger())
    state, gen = run["state"], run["generator"]
    with torch.no_grad():
        for shadow in state.ema.params.values():
            shadow.add_(0.01)
    trained = {n: p.detach().clone() for n, p in gen.named_parameters()}
    cfg = train_maskbit.SamplingConfig.from_config(config.model.mlm_model,
                                                  config.model.vq_model)
    sampler = train_maskbit.make_sampler(gen, run["tokenizer"], cfg)
    got = train_maskbit.generate(run, sampler, np.array([3, 5]), seed=11)
    for n, p in gen.named_parameters():
        assert torch.equal(p, trained[n]) and not torch.equal(p, state.ema.params[n])
    ema_model = LFQBert.from_config(MLM, TINY_VQ).eval()
    ema_model.load_state_dict(dict(gen.state_dict(), **state.ema.params))
    want, _ = train_maskbit.make_sampler(ema_model, run["tokenizer"], cfg)(
        torch.tensor([3, 5]), torch.Generator().manual_seed(11))
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(got, want.clamp(0, 1).float().numpy())
