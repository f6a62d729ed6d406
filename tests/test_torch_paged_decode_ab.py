"""``paged_decode_ab.py``'s parts that run without a card: the ptxas report
it prints per checkout, and its refusal of a single checkout."""

import pytest

import paged_decode_ab

# Two entries of ``nvcc -Xptxas -v`` output as ptxas prints them.
LOG = """\
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__480a19b3_15_paged_decode_cu_85be5c0a25paged_decode_split_kernelI13__nv_bfloat16Lb1ELi1ELi4ELi8EEEvPKT_S4_S4_PKiS6_PS2_PfS8_iiiiiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__480a19b3_15_paged_decode_cu_85be5c0a25paged_decode_split_kernelI13__nv_bfloat16Lb1ELi1ELi4ELi8EEEvPKT_S4_S4_PKiS6_PS2_PfS8_iiiiiiifi
    16 bytes stack frame, 32 bytes spill stores, 48 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 16 bytes cumulative stack size, 16512 bytes smem
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__480a19b3_15_paged_decode_cu_85be5c0a25paged_decode_merge_kernelIfEEvPKfS2_PT_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__480a19b3_15_paged_decode_cu_85be5c0a25paged_decode_merge_kernelIfEEvPKfS2_PT_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
"""


def test_ptxas_report_names_each_kernel_with_registers_and_spills():
    assert paged_decode_ab.ptxas_report(LOG) == [
        "paged_decode_split_kernel<13__nv_bfloat16Lb1ELi1ELi4ELi8>: "
        "168 regs, spill 32+48",
        "paged_decode_merge_kernel<f>: 32 regs, spill 0+0",
    ]


def test_one_checkout_is_refused_before_any_build():
    with pytest.raises(SystemExit) as exit_info:
        paged_decode_ab.main(["."])
    assert exit_info.value.code == 2
