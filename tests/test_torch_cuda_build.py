"""The kernel build cache: a library's name hashes its source and every
header under csrc/ that it includes, so an edited header rebuilds.

CPU only: the digest needs no nvcc."""

from maskbit_tpu_torch.nn import cuda_build


def _tree(tmp_path):
    inc = tmp_path / "csrc"
    inc.mkdir()
    (inc / "kernel.cu").write_text('#include <cuda.h>\n#include "a.cuh"\nint f();\n')
    (inc / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n#include "missing.cuh"\n')
    (inc / "b.cuh").write_text("#pragma once\nint b();\n")
    (inc / "other.cuh").write_text("int other();\n")
    return inc


def test_digest_follows_included_headers(tmp_path):
    inc = _tree(tmp_path)
    src = inc / "kernel.cu"
    first = cuda_build.source_digest(src, inc)
    assert first == cuda_build.source_digest(src, inc)
    (inc / "other.cuh").write_text("int other(int);\n")  # not included: same library
    assert cuda_build.source_digest(src, inc) == first
    (inc / "b.cuh").write_text("#pragma once\nint b(int);\n")  # included through a.cuh
    second = cuda_build.source_digest(src, inc)
    assert second != first
    (inc / "kernel.cu").write_text('#include <cuda.h>\n#include "a.cuh"\nint f(int);\n')
    assert cuda_build.source_digest(src, inc) not in (first, second)


def test_digest_finds_headers_in_the_include_directory(tmp_path):
    """A source outside csrc/ (a variant being compared) takes csrc/'s headers."""
    inc = _tree(tmp_path)
    variant = tmp_path / "variant.cu"
    variant.write_text('#include "a.cuh"\n')
    first = cuda_build.source_digest(variant, inc)
    (inc / "b.cuh").write_text("#pragma once\nint b(long);\n")
    assert cuda_build.source_digest(variant, inc) != first


def test_port_sources_hash_their_headers():
    """Both libraries include the shared headers (the forward's, which
    includes the Hopper helpers and the kernels past head dim 128, float32
    and bf16), and their names change with them."""
    for name in ("attention_block", "dropout_attention"):
        text = (cuda_build.CSRC / f"{name}.cu").read_text()
        assert '#include "attention_fwd.cuh"' in text
    headers = cuda_build._INCLUDE.findall((cuda_build.CSRC / "attention_fwd.cuh").read_text())
    assert headers == ["sm90.cuh", "attention_wide.cuh", "attention_wide_bf16.cuh"]


def test_float32_source_hashes_its_kernels_past_head_dim_128(tmp_path):
    """The float32 library alone includes the float32 kernels past 128
    (attention_wide_f32.cuh), after the shared headers, and its name changes
    with that header."""
    text = (cuda_build.CSRC / "attention_f32.cu").read_text()
    assert cuda_build._INCLUDE.findall(text) == ["attention_fwd.cuh", "layernorm.cuh",
                                                 "attention_wide_f32.cuh"]
    for name in ("attention_block", "dropout_attention"):
        assert "attention_wide_f32.cuh" not in (cuda_build.CSRC / f"{name}.cu").read_text()
    inc = tmp_path / "csrc"
    inc.mkdir()
    for f in cuda_build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (inc / f.name).write_text(f.read_text())
    first = cuda_build.source_digest(inc / "attention_f32.cu", inc)
    header = inc / "attention_wide_f32.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert cuda_build.source_digest(inc / "attention_f32.cu", inc) != first
