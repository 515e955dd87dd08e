"""`chip_smoke._check_wgmma_kernels`, on the CPU: the final record's check
that phases 3 and 17 ran the wgmma kernels past head dim 128 and none of
the mma.sync kernels they replaced (the card runs it in `chip_smoke.py`)."""

import pytest

import chip_smoke

F32 = {name: [*forms["float"]] for name, forms in chip_smoke.WIDE_CUDA_KERNELS.items()}


def _f32_row(d, **kernels):
    return {"d": d, "kernels": {**{name: ks[:1] for name, ks in F32.items()}, **kernels}}


def test_the_3xtf32_kernels_past_128_pass():
    block = ["attn_fwd_wide_tf32_kernel<256, false, false>", "proj_tf32_kernel<0>",
             "layernorm_kernel<float>"]
    chip_smoke._check_wgmma_kernels(
        [{"d": 64, "kernels": {"fused_attention": ["attn_fwd_kernel<64, false>"]}}, {"d": 64}],
        [{"d": 64}, _f32_row(256, fused_attention_block=block), _f32_row(192)])


@pytest.mark.parametrize("bf16,f32,match", [
    ([{"d": 32, "kernels": {"fused_attention": ["attn_fwd_mma_kernel<32>"]}}], [_f32_row(192)],
     "mma.sync kernels ran"),
    ([], [_f32_row(256, dropout_attention_bwd=["attn_bwd_wide_prep_kernel<float>",
                                               "attn_bwd_wide_kernel<float, 1>"])],
     "mma.sync kernels ran"),
    ([], [_f32_row(256, fused_attention=["attn_fwd_wide_bf16_kernel<256, false, false, 1>"])],
     "not the 3xTF32 ones"),
    ([], [{"d": 64}], "not the 3xTF32 ones"),
])
def test_an_mma_sync_or_foreign_kernel_past_128_fails(bf16, f32, match):
    with pytest.raises(AssertionError, match=match):
        chip_smoke._check_wgmma_kernels(bf16, f32)
