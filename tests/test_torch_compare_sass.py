"""`cli/compare_sass`'s parsing and comparison of `cuobjdump -sass` listings,
on the CPU (its builds need nvcc, on the card's machine)."""

from maskbit_tpu_torch.cli import compare_sass

LISTING = """
	code for sm_90a
		Function : _ZN53_GLOBAL__N__{h}_20_x_cu_6983a08815attn_fwd_kernelILi64ELb0EEEv
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
		Function : _ZN53_GLOBAL__N__{h}_20_x_cu_6983a08812other_kernelEv
        /*0000*/                   {op} ;
"""


def test_names_and_code_are_compared_without_the_namespace_hash():
    first = compare_sass.kernels(LISTING.format(h="455d5de6", op="EXIT"))
    second = compare_sass.kernels(LISTING.format(h="16731950", op="EXIT"))
    assert len(first) == 2 and first == second
    assert all("_GLOBAL__N__20_x_cu" in name for name in first)
    changed = compare_sass.kernels(LISTING.format(h="16731950", op="BRA 0x10"))
    got = compare_sass.compare(first, {**changed, "new_kernel": "0"})
    assert len(got["identical"]) == 1 and got["identical"][0].endswith("attn_fwd_kernelILi64ELb0EEEv")
    assert len(got["differ"]) == 1 and got["differ"][0].endswith("other_kernelEv")
    assert got["missing"] == [] and got["new"] == ["new_kernel"]
    assert compare_sass.compare(first, {})["missing"] == sorted(first)
    # the listing's column padding follows the library's longest instruction
    padded = compare_sass.kernels(LISTING.format(h="16731950", op="EXIT").replace(
        "LDC R1, c[0x0][0x28] ;", "LDC R1, c[0x0][0x28] ;   "))
    assert padded == first


def test_it_needs_two_trees(capsys):
    assert compare_sass.main(["--tree", "."]) == 2
    assert "two trees" in capsys.readouterr().out
