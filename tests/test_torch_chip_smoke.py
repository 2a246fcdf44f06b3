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


def test_viz_launch_record_and_signed_map(monkeypatch):
    """Phase 14 reads each attribution step's launches from a wrapper, and
    compares the fused and f32 maps as pos - neg per clip."""
    import torch

    class Kernel:
        launches = 0

    kernels = [Kernel() for _ in range(6)]
    fake = type("F", (), {"KERNELS": kernels})
    record = []

    def step(n):
        for k in kernels[:3]:
            k.launches += 2 * n
        for k in kernels[3:]:
            k.launches += n
        return n

    wrapped = chip_smoke._recorded_launches(fake, record)(step)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)  # no card here
    assert wrapped(4) == 4 and wrapped(4) == 4
    assert record == [[8, 8, 8, 4, 4, 4]] * 2
    pos = torch.tensor([[[1.0, 0.0]], [[0.0, 2.0]]])
    neg = torch.tensor([[[0.0, 3.0]], [[1.0, 0.0]]])
    got = chip_smoke._signed(pos, neg)
    assert got.dtype == torch.float64 and got.tolist() == [[1.0, -3.0], [-1.0, 2.0]]


def test_zoo_phase_is_wired_before_the_kernels_line_and_imports_no_jax():
    """Phase 17 (the rest of the recurrent zoo and the video ResNets) runs
    after phase 16 and before the kernels line, now phase 19, over every
    name its slice ported; the script imports nothing of JAX."""
    import ast
    import inspect

    from pathtracker_torch.models import registry

    main = inspect.getsource(chip_smoke.main)
    order = [main.index(call) for call in ("rbp_zoo_phase(", "rzoo_phase(", '{"kernels"')]
    assert order == sorted(order)
    doc = chip_smoke.__doc__
    assert doc.index("\n 16. ") < doc.index("\n 17. the rest of the recurrent zoo") \
        < doc.index("\n 19. one JSON line naming every kernel")
    assert set(chip_smoke.RZOO_MODELS) == set(registry.VIDEO_RESNETS) | {
        "stlstm", "fflstm", "lrcn", "lrcn_last", "ffnet"}
    assert set(chip_smoke.RZOO_BF16) <= set(registry.VIDEO_RESNETS)
    with open(chip_smoke.__file__) as f:
        tree = ast.parse(f.read())
    modules = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    modules |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not {m.split(".")[0] for m in modules} & {"jax", "jaxlib", "flax", "optax",
                                                      "pathtracker_tpu"}


def test_slowfast_phase_is_wired_before_the_kernels_line_and_imports_no_jax():
    """Phase 18 (SlowFast and the transformer baselines) runs after phase
    17 and before the kernels line (phase 19), over every name that slice
    ported, with SlowFast's dropout checked and the CLIs of one SlowFast
    and one transformer; the phase imports nothing of JAX."""
    import inspect

    from pathtracker_torch.models import registry

    main = inspect.getsource(chip_smoke.main)
    order = [main.index(call) for call in ("rzoo_phase(F", "sfzoo_phase(", '{"kernels"')]
    assert order == sorted(order)
    doc = chip_smoke.__doc__
    assert doc.index("\n 17. the rest of the recurrent zoo") < doc.index(
        "\n 18. SlowFast") < doc.index("\n 19. one JSON line naming every kernel")
    assert set(chip_smoke.SFZOO_MODELS) == set(registry.SLOWFAST) | set(registry.TRANSFORMERS)
    assert set(chip_smoke.SFZOO_DROPOUT) == set(registry.SLOWFAST)
    assert set(chip_smoke.SFZOO_CLI) <= set(chip_smoke.SFZOO_MODELS)
    assert {registry.family(n) for n in chip_smoke.SFZOO_CLI} == {"slowfast", "recurrent"}
    source = "".join(inspect.getsource(f) for f in (
        chip_smoke.sfzoo_phase, chip_smoke._dropout_gap, chip_smoke._rzoo_run,
        chip_smoke._rzoo_parity, chip_smoke._rzoo_cli, chip_smoke._rzoo_model))
    assert not any(word in source for word in ("jax", "flax", "optax", "pathtracker_tpu"))
    assert "launches" in inspect.getsource(chip_smoke.sfzoo_phase)
