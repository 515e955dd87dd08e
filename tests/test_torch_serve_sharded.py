"""The split sampler (`maskbit_tpu_torch/sampling/serve.py`: one worker
process per device) and its use by the serving and eval CLIs, on the CPU
at the tiny sizes of
`tests/test_parallel.py::test_sharded_sampler_matches_single_device`.

* `make_sharded_sampler` over `[cpu, cpu]` and `[cpu] * 4` at batch 8 with
  injected draws equals the port's one-device `make_sampler` row for row:
  tokens exactly, images within atol 1e-5 (float32: the replicas run the
  convolutions and linears on 4 or 2 rows where one device runs 8, which
  may sum in another order). Over the same weights and draws it equals the
  JAX package's sampler at the tolerance of
  `test_torch_sampler.py::test_slice_make_sampler_matches_jax_chain`
  (tokens exactly, images atol 1e-4). Each replica holds the caller's
  weights bit for bit.
* Without injected draws, a seeded split run repeats itself, and shard i's
  rows are a one-device call's on those rows with a generator seeded
  `derive_seed(base, i)` (`base` one draw of the caller's generator).
* A worker killed in the middle of a call, or one that stops answering,
  makes the call raise within its deadline, and one that cannot start
  makes the start raise; no worker outlives `close()` or the failure.
* `cli.serve` with `sampling.serve.local_devices` patched to 2 CPU
  "cards" and `serve.shard_local_devices=true`: a batch that divides is
  split (a seeded /generate returns the same bytes twice, through the
  split sampler), one that does not keeps one device, as the JAX server
  does; `serve.shard_local_devices=false`, and the port's default, keep
  one device; the workers stop with the server.
* `cli.eval_maskbit` on 2 and 4 "cards": `eval.batch_size` 7 and 6 are
  rounded up to 8 and exactly `eval.total_samples` are scored, each label
  once, with the split on by default or asked for; the workers stop when
  the run ends.
"""

import io
import json
import multiprocessing as mp
import os
import signal
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from maskbit_tpu.models.generator import LFQBert as JaxLFQBert
from maskbit_tpu.models.tokenizer import ConvVQModel as JaxConvVQModel
from maskbit_tpu.ops.bitops import combine_factorized_tokens as jax_combine
from maskbit_tpu.sampling import sample as jsample
from maskbit_tpu_torch.compat.weights import generator_from_flax, tokenizer_from_flax
from maskbit_tpu_torch.models.generator import LFQBert
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from maskbit_tpu_torch.sampling import sample as tsample
from maskbit_tpu_torch.sampling import serve as split
from tests.test_cli_eval_demo import DATASET, TINY_MLM, TINY_VQ

torch.set_num_threads(2)

# tests/test_parallel.py:227-244's sizes: depth 1, hidden 32, 2 heads, a 4x4
# token grid of 2 splits of 8 bits, 3 steps of CFG 1.5
VQ = {"model_class": "vqgan+", "quantizer_type": "lookup-free", "codebook_size": 256,
      "token_size": 8, "num_channels": 3, "hidden_channels": 32, "channel_mult": [1, 2],
      "num_resolutions": 2, "num_res_blocks": 1, "entropy_loss_weight": 0.0}
MLM = {"img_size": 8, "hidden_dim": 32, "codebook_splits": 2, "depth": 1, "heads": 2,
       "mlp_dim": 64, "dropout": 0.0, "nclass": 10, "input_stride": 2, "num_steps": 3,
       "guidance_scale": 1.5, "attention_impl": "fused"}
BATCH = 8
IMAGE_ATOL, JAX_IMAGE_ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def models():
    jgen = JaxLFQBert.from_config(MLM, VQ)
    jtok = JaxConvVQModel.from_config(VQ)
    gen_vars = jgen.init(jax.random.key(0), jnp.zeros((1, jgen.seq_len, 2), jnp.int32),
                         jnp.zeros((1,), jnp.int32))
    tok_vars = jtok.init(jax.random.key(1), jnp.zeros((1, 8, 8, 3)))
    tgen = generator_from_flax(jax.tree.map(np.asarray, gen_vars),
                               LFQBert.from_config(MLM, VQ).eval())
    ttok = tokenizer_from_flax(jax.tree.map(np.asarray, tok_vars),
                               ConvVQModel.from_config(VQ).eval(), VQ["codebook_size"])
    cfg = tsample.SamplingConfig.from_config(MLM, VQ)._replace(patch_size=4)
    jcfg = jsample.SamplingConfig.from_config(MLM, VQ)._replace(patch_size=4)
    assert tuple(cfg) == tuple(jcfg)
    rng = np.random.default_rng(7)
    n = cfg.patch_size**2
    draws = (rng.integers(0, cfg.mask_token, size=(cfg.num_steps, BATCH, n, 2)).astype(np.int32),
             rng.gumbel(size=(cfg.num_steps, BATCH, n, 2)).astype(np.float32))
    labels = (np.arange(BATCH) % 10).astype(np.int32)
    return {"jax": (jgen, jtok, gen_vars, tok_vars, jcfg), "port": (tgen, ttok, cfg),
            "draws": draws, "labels": labels}


@pytest.mark.parametrize("n_devices", [2, 4], ids=["cpu-x2", "cpu-x4"])
def test_split_sampler_equals_one_device_and_jax(models, n_devices):
    tgen, ttok, cfg = models["port"]
    labels = torch.from_numpy(models["labels"])
    draws = tuple(torch.from_numpy(d) for d in models["draws"])
    want_images, want_tokens = tsample.make_sampler(tgen, ttok, cfg)(labels, injected=draws)
    with split.make_sharded_sampler(tgen, ttok, cfg, ["cpu"] * n_devices) as sampler:
        assert len(sampler.devices) == n_devices and len(set(sampler.pids)) == n_devices
        images, tokens = sampler(labels, injected=draws)
        # every replica holds the caller's weights, bit for bit
        for gen_state, tok_state in sampler.replica_states():
            for got, want in ((gen_state, tgen.state_dict()), (tok_state, ttok.state_dict())):
                assert got.keys() == want.keys()
                for key, value in want.items():
                    assert torch.equal(got[key], value), key
    _assert_stopped(sampler)
    assert images.shape == (BATCH, 8, 8, 3) and images.device.type == "cpu"
    np.testing.assert_array_equal(tokens.numpy(), want_tokens.numpy())
    np.testing.assert_allclose(images.numpy(), want_images.numpy(), atol=IMAGE_ATOL, rtol=0)

    jgen, jtok, gen_vars, tok_vars, jcfg = models["jax"]

    def logits_fn(t, y, drop):
        return jgen.apply(gen_vars, t, y, drop, deterministic=True)

    jtokens, _ = jsample.sample_tokens(logits_fn, jax.random.key(0),
                                       jnp.asarray(models["labels"]), jcfg,
                                       injected=models["draws"])
    jcombined = jax_combine(jtokens, jcfg.codebook_size, jcfg.codebook_splits)
    jimages = jtok.apply(tok_vars, jcombined, method="decode_tokens")
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jcombined))
    np.testing.assert_allclose(images.numpy(), np.asarray(jimages), atol=JAX_IMAGE_ATOL, rtol=0)


def test_split_sampler_seeded_draws_and_refusals(models):
    tgen, ttok, cfg = models["port"]
    labels = torch.from_numpy(models["labels"])
    one = tsample.make_sampler(tgen, ttok, cfg)
    with split.make_sharded_sampler(tgen, ttok, cfg, ["cpu", "cpu"]) as sampler:
        a = sampler(labels, torch.Generator().manual_seed(3))
        b = sampler(labels, torch.Generator().manual_seed(3))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        # shard i draws from a generator seeded derive_seed(base, i)
        base = int(torch.randint(0, 2**62, (1,), generator=torch.Generator().manual_seed(3)))
        for i, rows in enumerate((slice(0, 4), slice(4, 8))):
            want = one(labels[rows], torch.Generator().manual_seed(split.derive_seed(base, i)))
            assert torch.equal(a[1][rows], want[1])
            np.testing.assert_allclose(a[0][rows].numpy(), want[0].numpy(), atol=IMAGE_ATOL,
                                       rtol=0)
        # shard 1 draws from its own stream: its rows are not shard 0's draws
        # for the same labels
        same = sampler(torch.cat([labels[:4], labels[:4]]), torch.Generator().manual_seed(3))
        assert not torch.equal(same[1][:4], same[1][4:])
        with pytest.raises(ValueError, match="does not divide"):
            sampler(labels[:7], torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="Generator or injected"):
            sampler(labels)
        assert [c["attention_block"] for c in sampler.launch_counts()] == [0, 0]  # no card
    _assert_stopped(sampler)
    with pytest.raises(RuntimeError, match="closed"):
        sampler(labels, torch.Generator().manual_seed(3))
    assert split.local_devices("cpu") == [torch.device("cpu")]
    assert split.local_devices("cuda:1") == [torch.device("cuda", 1)]
    assert split.derive_seed(1, 0) != split.derive_seed(1, 1)


def _assert_stopped(sampler):
    """No worker of `sampler` is left running."""
    for proc in sampler._procs:
        assert not proc.is_alive() and proc.exitcode is not None
    for pid in sampler.pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


@pytest.mark.parametrize("fault", ["killed", "silent", "start"])
def test_split_sampler_raises_when_a_worker_fails(models, fault):
    """A worker killed while it holds a call, one that stops answering, or
    one that cannot take its replica to its device makes the call (or the
    start) raise within the deadline, and every worker stops."""
    tgen, ttok, cfg = models["port"]
    labels = torch.from_numpy(models["labels"])
    timeout = 20.0
    if fault == "start":  # no XPU here: the second worker fails to start
        with pytest.raises(RuntimeError, match="worker 1 on xpu raised"):
            split.make_sharded_sampler(tgen, ttok, cfg, ["cpu", "xpu"], timeout=timeout)
        assert not [p for p in mp.active_children() if p.name.startswith("sampler-")]
        return
    sampler = split.make_sharded_sampler(tgen, ttok, cfg, ["cpu", "cpu"], timeout=timeout)
    try:
        sampler(labels, torch.Generator().manual_seed(0))
        os.kill(sampler.pids[1], signal.SIGSTOP)  # the request waits in its pipe
        if fault == "killed":
            threading.Timer(0.5, os.kill, (sampler.pids[1], signal.SIGKILL)).start()
            sampler.timeout = 600.0  # the death, not the deadline, must end the call
        else:
            sampler.timeout = 2.0
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="died" if fault == "killed" else "no answer"):
            sampler(labels, torch.Generator().manual_seed(0))
        assert time.monotonic() - t0 < timeout
    finally:
        sampler.close()
    _assert_stopped(sampler)


def _cards(monkeypatch, n=2):
    monkeypatch.setattr(split, "local_devices", lambda device: [torch.device("cpu")] * n)


def _serve(tmp_path, **serve):
    from maskbit_tpu_torch.cli.serve import main

    cfg = {"experiment": {"name": "split", "vqgan_checkpoint": "", "generator_checkpoint": ""},
           "model": {"vq_model": TINY_VQ, "mlm_model": dict(TINY_MLM, attention_impl="fused")},
           "dataset": DATASET,
           "training": {"per_device_batch_size": 2, "mixed_precision": "no", "seed": 0},
           "serve": {"port": 0, "device": "cpu", **serve}}
    path = tmp_path / "serve.yaml"
    path.write_text(yaml.safe_dump(cfg))
    server, service = main([f"config={path}"], serve_forever=False)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, service, f"http://127.0.0.1:{server.server_address[1]}"


def _generate(base, body):
    req = urllib.request.Request(f"{base}/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()


ON = {"shard_local_devices": True}


@pytest.mark.parametrize("batch,shard", [(2, ON), (4, ON), (3, ON),
                                         (2, {"shard_local_devices": False}), (2, {})],
                         ids=["batch2-split", "batch4-split", "batch3-one-device",
                              "switched-off", "default-one-device"])
def test_serve_splits_a_dividing_batch_over_local_devices(tmp_path, monkeypatch, batch, shard):
    _cards(monkeypatch)
    made = []
    real = split.make_sharded_sampler
    monkeypatch.setattr(split, "make_sharded_sampler",
                        lambda *a, **k: made.append(real(*a, **k)) or made[-1])
    server, service, base = _serve(tmp_path, batch_size=batch, **shard)
    try:
        splits = batch % 2 == 0 and shard.get("shard_local_devices", False)
        assert len(made) == int(splits)
        assert (service._sampler is made[0]) if splits else not made
        first = _generate(base, {"labels": [1, 7, 282], "seed": 5})
        again = _generate(base, {"labels": [1, 7, 282], "seed": 5})
        assert first == again  # a seeded request: the same bytes
        images = np.load(io.BytesIO(first))["images"]
        assert images.shape == (3, 32, 32, 3) and images.dtype == np.uint8 and images.std() > 0
        if splits:
            assert made[0].devices == [torch.device("cpu")] * 2
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    for sampler in made:  # the workers stop with the server
        _assert_stopped(sampler)


@pytest.mark.parametrize("cards,batch,shard", [(2, 7, True), (4, 6, True), (2, 7, None),
                                               (2, 7, False)],
                         ids=["7-over-2", "6-over-4", "default-one-device", "switched-off"])
def test_eval_maskbit_rounds_the_batch_up_over_two_devices(tmp_path, monkeypatch, cards, batch,
                                                           shard):
    from maskbit_tpu_torch.cli import eval_maskbit as em

    _cards(monkeypatch, cards)
    batches, made, samplers = [], [], []

    def recording(make):
        def build(*args, **kwargs):
            sampler = make(*args, **kwargs)
            made.append(make)
            samplers.append(sampler)

            def run(labels, rng):
                batches.append(labels.clone())
                return sampler(labels, rng)

            if hasattr(sampler, "close"):
                run.close = sampler.close
            return run

        return build

    def stub_inception(images_255):
        x = images_255.double().reshape(images_255.shape[0], -1) / 255.0
        w = torch.randn(x.shape[1], 2048 + 1008, generator=torch.Generator().manual_seed(5),
                        dtype=torch.float64) / 8.0
        y = x @ w
        return {"2048": torch.tanh(y[:, :2048]), "logits_unbiased": y[:, 2048:]}

    sharded, one = split.make_sharded_sampler, em.make_sampler
    monkeypatch.setattr(split, "make_sharded_sampler", recording(sharded))
    monkeypatch.setattr(em, "make_sampler", recording(one))
    monkeypatch.setattr(em, "make_inception_fn", lambda device: stub_inception)
    cfg = {"experiment": {"name": "split_eval", "vqgan_checkpoint": "",
                          "generator_checkpoint": "", "output_dir": str(tmp_path / "out")},
           "model": {"vq_model": TINY_VQ, "mlm_model": dict(TINY_MLM, attention_impl="fused")},
           "dataset": DATASET, "training": {"mixed_precision": "no", "seed": 0},
           "eval": {"device": "cpu", "total_samples": 10, "batch_size": batch}}
    if shard is not None:
        cfg["eval"]["shard_local_devices"] = shard
    path = tmp_path / "eval.yaml"
    path.write_text(yaml.safe_dump(cfg))
    result = em.main([f"config={path}"])
    if shard is not False:  # split, by default as when asked for
        assert made == [sharded]
        assert [len(b) for b in batches] == [8, 8]  # rounded up to 8 to fill every shard
        _assert_stopped(samplers[0])  # the workers stop when the run ends
    else:  # one device, the batch as given
        assert made == [one]
        assert [len(b) for b in batches] == [batch, batch]
    assert result["count"] == 10 and result["accumulator"].count == 10
    labels = em.class_balanced_labels(10, 0)
    np.testing.assert_array_equal(torch.cat(batches)[:10].numpy(), labels)
    assert not torch.cat(batches)[10:].any()  # the pad rows sample class 0
    assert "InceptionScore" in result["results"]
