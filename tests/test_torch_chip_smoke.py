"""chip_smoke.py's helpers that need no card: reading ptxas -v's account of
each kernel, and counting the in-image products of the correlation."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115corr_bwd_kernelILb1ELb1ELi15EEEvPKfS2_Pfiiiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115corr_bwd_kernelILb1ELb1ELi15EEEvPKfS2_Pfiiiiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115corr_bwd_kernelILb0ELb0ELi0EEEvPKfS2_Pfiiiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115corr_bwd_kernelILb0ELb0ELi0EEEvPKfS2_Pfiiiiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 122 registers, used 1 barriers, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115corr_fwd_kernelILb1EEEvPKfS2_Pfiiiiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115corr_fwd_kernelILb1EEEvPKfS2_Pfiiiiiiiiii
    56 bytes stack frame, 80 bytes spill stores, 80 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 56 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115corr_fwd_kernelILb1ELi15EEEvPKfS2_Pfiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115corr_fwd_kernelILb1ELi15EEEvPKfS2_Pfiiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111k1_bwd_kernelEPKfS1_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111k1_bwd_kernelEPKfS1_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 124 registers, used 1 barriers
"""


def test_resource_lines_name_every_kernel_instance():
    lines = chip_smoke.resource_lines(PTXAS_LOG)
    assert lines == [
        "corr_bwd_kernel<1, 1, 15>: Used 168 registers, used 1 barriers, 420 bytes "
        "cmem[0]; 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "corr_bwd_kernel<0, 0, 0>: Used 122 registers, used 1 barriers, 420 bytes "
        "cmem[0]; 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "corr_fwd_kernel<1>: Used 128 registers, used 1 barriers, 56 bytes cumulative "
        "stack size; 56 bytes stack frame, 80 bytes spill stores, 80 bytes spill loads",
        "corr_fwd_kernel<1, 15>: Used 255 registers, used 1 barriers; 0 bytes stack "
        "frame, 0 bytes spill stores, 0 bytes spill loads",
        "k1_bwd_kernel: Used 124 registers, used 1 barriers; 0 bytes stack frame, "
        "0 bytes spill stores, 0 bytes spill loads",
    ]


def test_in_image_terms_count_the_products_that_touch_the_image():
    # One axis of 32 positions, 15 displacements: 32*15 pairs less the
    # 2 * (7+6+...+1) = 56 that land in the padding.
    assert chip_smoke._in_image_terms(32, 15, 1) == 32 * 15 - 56
    assert chip_smoke._in_image_terms(5, 1, 1) == 5
    assert chip_smoke._in_image_terms(4, 3, 2) == 4 * 3 - 4


def test_instance_names_a_profiled_kernel_as_resource_lines_does():
    # The demangled names a device trace gives, template arguments and all.
    assert chip_smoke._instance(
        "void (anonymous namespace)::corr_bwd_kernel<false, true, 15>(float const*, "
        "float const*, float*, int, int)") == "corr_bwd_kernel<0, 1, 15>"
    assert chip_smoke._instance(
        "void corr_bwd_kernel<(bool)1, (bool)1, 15>(float const*)") == "corr_bwd_kernel<1, 1, 15>"
    assert chip_smoke._instance("corr_fwd_kernel<true, 15>(float const*)") == \
        "corr_fwd_kernel<1, 15>"
    assert chip_smoke._instance("void (anonymous namespace)::k1_kernel(float const*)") == \
        "k1_kernel"
