"""`cli/compare_forward_f32`'s arguments, on the CPU (its builds and timings
need the card and run in `chip_smoke.py`'s environment)."""

import os

from maskbit_tpu_torch.cli import compare_forward_f32


def test_trees_come_before_the_sources_and_head_dims_parse():
    args = compare_forward_f32._args(["--tree", "old", "--tree", ".", "new.cu",
                                      "--head-dims", "32,64,128"])
    assert args.sources == [os.path.join("old", "maskbit_tpu_torch", "csrc", "attention_f32.cu"),
                            os.path.join(".", "maskbit_tpu_torch", "csrc", "attention_f32.cu"),
                            "new.cu"]
    assert args.head_dims == [32, 64, 128]
    assert compare_forward_f32._args(["a.cu", "b.cu"]).head_dims == [64]


def test_it_needs_two_sources(capsys):
    assert compare_forward_f32.main(["only.cu"]) == 2
    assert "side by side" in capsys.readouterr().out
