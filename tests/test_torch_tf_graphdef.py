"""Port parity: the frozen-graph extractor (`compat/tf_graphdef.py`) against JAX.

The synthetic GraphDef of `tests/test_tf_graphdef.py` (the full 2015
topology, 94 conv units, random weights, one conv with epsilon 0.002, one
with `scale_after_normalization`) goes through both extractors: the port's
state dict equals the JAX package's Flax tree carried across with
`export_inception_state`, exactly. The port's `main` writes a `.pth` that
`MASKBIT_INCEPTION_WEIGHTS` loads through `make_inception_fn`, and
`MASKBIT_ADM_PB` takes precedence over it.
"""

import numpy as np
import pytest
import torch

from maskbit_tpu.compat import tf_graphdef as jax_tfg
from maskbit_tpu_torch.cli.eval_tokenizer import make_inception_fn
from maskbit_tpu_torch.compat import tf_graphdef as tfg
from maskbit_tpu_torch.compat.torch_export import export_inception_state
from maskbit_tpu_torch.eval.inception import inception_from_state
from tests.test_tf_graphdef import build_inception_graphdef

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def graph():
    return build_inception_graphdef(seed=0)[0]


def test_extraction_equals_jax_carried_across(graph):
    want = export_inception_state(jax_tfg.extract_inception_params(graph))
    got = tfg.extract_inception_state(graph)
    assert got.keys() == want.keys()
    assert sum(k.endswith("conv.weight") for k in got) == 94
    for key, value in want.items():
        assert got[key].numpy().dtype == value.dtype, key
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


def test_shape_mismatch_raises():
    data, _ = build_inception_graphdef(seed=1, corrupt="conv_3")
    with pytest.raises(ValueError):
        tfg.extract_inception_state(data)


def test_main_writes_a_pth_that_make_inception_fn_loads(tmp_path, graph, monkeypatch):
    pb = tmp_path / "classify_image_graph_def.pb"
    pb.write_bytes(graph)
    out = tmp_path / "inception_adm.pth"
    tfg.main([str(pb), str(out)])
    state = torch.load(out, weights_only=True)
    images = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    with torch.inference_mode():
        want = inception_from_state(tfg.extract_inception_state(graph), "cpu")(
            torch.from_numpy(images))

    monkeypatch.delenv("MASKBIT_ADM_PB", raising=False)
    monkeypatch.setenv("MASKBIT_INCEPTION_WEIGHTS", str(out))
    got = make_inception_fn("cpu")(images)
    assert set(state) == set(tfg.extract_inception_state(graph))
    for key in ("2048", "logits_unbiased"):
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
        assert torch.isfinite(got[key]).all()

    # the graph takes precedence over the .pth; without either there is no fn
    torch.save({k: v * 2 if v.is_floating_point() else v for k, v in state.items()}, out)
    monkeypatch.setenv("MASKBIT_ADM_PB", str(pb))
    torch.testing.assert_close(make_inception_fn("cpu")(images)["2048"], want["2048"],
                               rtol=0, atol=0)
    monkeypatch.setenv("MASKBIT_ADM_PB", str(tmp_path / "absent.pb"))
    monkeypatch.setenv("MASKBIT_INCEPTION_WEIGHTS", str(tmp_path / "absent.pth"))
    assert make_inception_fn("cpu") is None
