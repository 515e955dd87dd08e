"""`cli/compare_backward`'s arguments and its check of a source's interface,
on the CPU (its builds and timings need the card and run in
`chip_smoke.py`'s environment)."""

import os

import pytest

from maskbit_tpu_torch.cli import compare_backward


@pytest.mark.parametrize("dtype,source", [(None, "dropout_attention.cu"),
                                          ("float32", "attention_f32.cu")])
def test_trees_take_the_dtypes_source(dtype, source):
    argv = ["--tree", "old", "--tree", ".", "new.cu", "--head-dims", "192,256", "--forward"]
    args = compare_backward._args(argv + (["--dtype", dtype] if dtype else []))
    assert args.dtype == (dtype or "bf16") and args.forward
    assert args.sources == [os.path.join("old", "maskbit_tpu_torch", "csrc", source),
                            os.path.join(".", "maskbit_tpu_torch", "csrc", source), "new.cu"]
    assert args.head_dims == [192, 256]


def test_a_source_without_the_head_dim_is_refused_before_the_build(tmp_path):
    """A float32 source whose backward takes no `int d` (or a bf16 source
    given as float32) is refused, with no nvcc run."""
    old = tmp_path / "attention_f32.cu"
    old.write_text('extern "C" int mb_dropout_attention_bwd_f32(const void* q, int B, int n);\n')
    bf16 = tmp_path / "dropout_attention.cu"
    bf16.write_text('extern "C" int mb_dropout_attention_bwd(const void* q, int n, int d);\n')
    for src in (old, bf16):
        with pytest.raises(ValueError, match="mb_dropout_attention_bwd_f32 takes no head dim"):
            compare_backward.build([str(src)], "float32")


def test_it_needs_two_sources(capsys):
    assert compare_backward.main(["--dtype", "float32", "only.cu"]) == 2
    assert "side by side" in capsys.readouterr().out
