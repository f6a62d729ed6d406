"""``flash_bwd_ab.py``'s parts that run without a card: the ptxas report it
prints per build, and its refusal of a single checkout."""

import pytest

import flash_bwd_ab

# Two entries of ``nvcc -Xptxas -v`` output as ptxas prints them.
LOG = """\
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__0c583366_12_flash_bwd_cu_9f8ff7a523flash_bwd_kv_mma_kernelILi64ELb1EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PfPS1_S7_iiiiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__0c583366_12_flash_bwd_cu_9f8ff7a523flash_bwd_kv_mma_kernelILi64ELb1EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PfPS1_S7_iiiiiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 254 registers, used 1 barriers, 576 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__0c583366_12_flash_bwd_cu_9f8ff7a520flash_bwd_f32_kernelILi128ELb0EEEvPKfS2_S2_S2_S2_S2_PfS3_S3_iiiiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__0c583366_12_flash_bwd_cu_9f8ff7a520flash_bwd_f32_kernelILi128ELb0EEEvPKfS2_S2_S2_S2_S2_PfS3_S3_iiiiiiiif
    8 bytes stack frame, 104 bytes spill stores, 96 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 576 bytes cmem[0]
"""


def test_ptxas_report_names_each_kernel_with_registers_and_spills():
    assert flash_bwd_ab.ptxas_report(LOG) == [
        "flash_bwd_kv_mma_kernelILi64ELb1: 254 regs, spill 0+0",
        "flash_bwd_f32_kernelILi128ELb0: 255 regs, spill 104+96",
    ]


def test_one_checkout_is_refused_before_any_build():
    with pytest.raises(SystemExit) as exit_info:
        flash_bwd_ab.main(["."])
    assert exit_info.value.code == 2
