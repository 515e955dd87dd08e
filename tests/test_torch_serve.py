"""The port's HTTP server on CPU: the JAX server's tests (tests/test_serve.py)
on `serve.device=cpu`, with the fused attention block in the tiny model."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import yaml

from tests.test_cli_eval_demo import DATASET, TINY_MLM, TINY_VQ

torch.set_num_threads(2)


def _cfg_dict(**serve):
    return {
        "experiment": {"name": "serve_t", "logger": "jsonl", "resume": False,
                       "vqgan_checkpoint": "", "generator_checkpoint": ""},
        "model": {"vq_model": TINY_VQ, "mlm_model": dict(TINY_MLM, attention_impl="fused")},
        "dataset": DATASET,
        "training": {"per_device_batch_size": 2, "mixed_precision": "no", "seed": 0},
        "serve": {"port": 0, "batch_size": 2, "device": "cpu", **serve},
    }


def _start(tmp_path, cfg):
    from maskbit_tpu_torch.cli.serve import main

    path = tmp_path / "serve.yaml"
    path.write_text(yaml.safe_dump(cfg))
    server, service = main([f"config={path}"], serve_forever=False)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, service, f"http://127.0.0.1:{server.server_address[1]}"


def _post(base, body, timeout=120):
    req = urllib.request.Request(f"{base}/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def test_serve_generate(tmp_path):
    server, service, base = _start(tmp_path, _cfg_dict())
    try:
        with urllib.request.urlopen(f"{base}/healthz") as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["warm"] and health["batch_size"] == 2

        # 3 labels > batch 2: chunking + padding
        images = np.load(io.BytesIO(_post(base, {"labels": [1, 7, 282], "seed": 5})))["images"]
        assert images.shape == (3, 32, 32, 3) and images.dtype == np.uint8
        assert images.std() > 0
        again = np.load(io.BytesIO(_post(base, {"labels": [1, 7, 282], "seed": 5})))["images"]
        np.testing.assert_array_equal(images, again)  # same seed -> same bytes
        other = np.load(io.BytesIO(_post(base, {"labels": [1, 7, 282], "seed": 6})))["images"]
        assert not np.array_equal(images, other)

        assert _post(base, {"labels": [1], "format": "png"})[:8] == b"\x89PNG\r\n\x1a\n"
        npz = np.load(io.BytesIO(_post(base, {"labels": [1], "seed": 1, "format": "npz"})))
        assert npz["images"].shape == (1, 32, 32, 3)

        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, {"labels": [5000]})
        assert e.value.code == 400
    finally:
        server.shutdown()
        service.close()


def test_serve_micro_batching_and_caps(tmp_path):
    cfg = _cfg_dict(batch_size=4, batch_wait_ms=300, max_labels=6, max_body_bytes=4096)
    server, service, base = _start(tmp_path, cfg)
    try:
        calls_before = service.device_calls
        results, errors = [None] * 4, []

        def hit(i):
            try:
                results[i] = np.load(io.BytesIO(_post(base, {"labels": [i]})))["images"]
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not errors, errors
        for imgs in results:
            assert imgs is not None and imgs.shape == (1, 32, 32, 3)
        calls = service.device_calls - calls_before
        assert calls <= 2, f"no micro-batching: {calls} device calls for 4 requests"

        for body in ({"labels": [0] * 7}, {"labels": [0], "pad": "x" * 8192}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base, body)
            assert e.value.code == 400
    finally:
        server.shutdown()
        service.close()


def test_profile_sampler_reports_layers(tmp_path, capsys):
    """The profiling tool drives the same service and breaks its call down."""
    from maskbit_tpu_torch.cli import profile_sampler

    assert profile_sampler.layer_of("gemm_bias_kernel<...>").startswith("attention block")
    assert profile_sampler.layer_of("aten::add").startswith("other")
    path = tmp_path / "serve.yaml"
    path.write_text(yaml.safe_dump(_cfg_dict()))
    profile_sampler.main([f"config={path}"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("one sampler call, batch 2 on cpu") and len(lines) > 2
    assert any("ms" in line and "%" in line for line in lines[1:])


def test_serve_cuda_requested_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from maskbit_tpu_torch.cli.serve import main

    path = tmp_path / "serve.yaml"
    cfg = _cfg_dict()
    del cfg["serve"]["device"]  # default: cuda
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([f"config={path}"], serve_forever=False)
