"""`experiment.profile_steps` in the port's two training CLIs, on the CPU.

Each trainer runs 3 steps of its tiny config (`tests/test_torch_train_cli.py`,
`tests/test_torch_train_tokenizer_cli.py`): with `profile_steps="2-2"` the
third step (the one that starts with 2 steps done, as JAX's `ProfilerHook`
counts) is traced into one Chrome trace under `<output_dir>/profile`; with
the key empty, or absent, no such directory is made.
"""

import json

import pytest

from maskbit_tpu_torch.cli import train_maskbit, train_tokenizer
from tests import test_torch_train_cli, test_torch_train_tokenizer_cli

TRAINERS = {"maskbit": (train_maskbit.main, test_torch_train_cli._config),
            "tokenizer": (train_tokenizer.main,
                          lambda tmp_path: test_torch_train_tokenizer_cli._config(tmp_path)[0])}


@pytest.mark.parametrize("spec", ["2-2", "", None])
@pytest.mark.parametrize("trainer", sorted(TRAINERS))
def test_profile_steps_traces_the_window(tmp_path, trainer, spec):
    main, config = TRAINERS[trainer]
    argv = [f"config={config(tmp_path)}", "training.max_train_steps=3"]
    if spec is not None:
        argv.append(f"experiment.profile_steps={spec}")
    result = main(argv)
    assert result["steps"] == 3
    profile = tmp_path / "out" / "profile"
    if not spec:
        assert not profile.exists()
        return
    traces = sorted(p.name for p in profile.iterdir())
    assert traces == ["steps_2-2_rank0.json"]
    events = json.loads((profile / traces[0]).read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)  # the step's operators were recorded
