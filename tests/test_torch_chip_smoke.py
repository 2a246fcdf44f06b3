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
        < doc.index("\n 20. one JSON line naming every kernel")
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
    17 and before the kernels line (phase 20), over every name that slice
    ported, with SlowFast's dropout checked and the CLIs of one SlowFast
    and one transformer; the phase imports nothing of JAX."""
    import inspect

    from pathtracker_torch.models import registry

    main = inspect.getsource(chip_smoke.main)
    order = [main.index(call) for call in ("rzoo_phase(F", "sfzoo_phase(", '{"kernels"')]
    assert order == sorted(order)
    doc = chip_smoke.__doc__
    assert doc.index("\n 17. the rest of the recurrent zoo") < doc.index(
        "\n 18. SlowFast") < doc.index("\n 20. one JSON line naming every kernel")
    assert set(chip_smoke.SFZOO_MODELS) == set(registry.SLOWFAST) | set(registry.TRANSFORMERS)
    assert set(chip_smoke.SFZOO_DROPOUT) == set(registry.SLOWFAST)
    assert set(chip_smoke.SFZOO_CLI) <= set(chip_smoke.SFZOO_MODELS)
    assert {registry.family(n) for n in chip_smoke.SFZOO_CLI} == {"slowfast", "recurrent"}
    source = "".join(inspect.getsource(f) for f in (
        chip_smoke.sfzoo_phase, chip_smoke._dropout_gap, chip_smoke._rzoo_run,
        chip_smoke._rzoo_parity, chip_smoke._rzoo_cli, chip_smoke._rzoo_model))
    assert not any(word in source for word in ("jax", "flax", "optax", "pathtracker_tpu"))
    assert "launches" in inspect.getsource(chip_smoke.sfzoo_phase)


def test_chain_phase_is_wired_before_the_kernels_line_and_imports_no_jax():
    """Phase 19 (the canonical chain through its driver, the report, the
    matrix) runs after phase 18 and before the kernels line, cuts only the
    depth (the driver's batch, fused steps, model and width stay its
    defaults), counts every stage's launches, and imports nothing of JAX,
    nor do the two drivers it runs."""
    import inspect

    main = inspect.getsource(chip_smoke.main)
    order = [main.index(call) for call in ("sfzoo_phase(", "chain_phase(", '{"kernels"')]
    assert order == sorted(order)
    doc = chip_smoke.__doc__
    assert doc.index("\n 18. SlowFast") < doc.index("\n 19. the canonical warm-start") \
        < doc.index("\n 20. one JSON line naming every kernel")
    assert set(chip_smoke.CHAIN_DEPTH) == {"SYNTH_TRAIN", "SYNTH_TEST", "EPOCHS_A",
                                           "EPOCHS_B", "EPOCHS_C"}
    assert int(chip_smoke.CHAIN_DEPTH["SYNTH_TRAIN"]) % chip_smoke.BATCH == 0
    assert [(t, d) for _, t, d in chip_smoke.CHAIN_STAGES] == [(8, 1), (32, 5), (64, 14)]
    source = inspect.getsource(chip_smoke.chain_phase)
    assert "PATHTRACKER_LAUNCHES" in source and "launches_chain" in source
    for name in ("torch_reproduce_canonical.py", "torch_eval_matrix.py"):
        with open(os.path.join(ROOT, "scripts", name)) as f:
            text = f.read()
        assert not any(w in text for w in ("import jax", "from jax", "pathtracker_tpu."))


def test_parallel_phase_is_wired_into_the_resident_phase_and_its_ranks():
    """Phase 13 (h) runs on phase 13's clips before they are dropped, and
    before the kernels line; ``chip_smoke.py --parallel-rank`` is one of
    its ranks, dispatched before the card check so that a rank prints no
    result line; the phase imports nothing of JAX."""
    import inspect

    resident = inspect.getsource(chip_smoke.resident_phase)
    assert resident.index("remat_phase(") < resident.index("parallel_phase(") \
        < resident.index("del clips")
    main = inspect.getsource(chip_smoke.main)
    assert main.index('"--parallel-rank"') < main.index("torch.cuda.is_available()")
    assert main.index("resident_phase(") < main.index('{"kernels"')
    assert "(h) data-parallel" in chip_smoke.__doc__
    assert set(chip_smoke.PARALLEL_PATHS) == {"bf16", "f32"}
    source = "".join(inspect.getsource(f) for f in (
        chip_smoke.parallel_phase, chip_smoke.parallel_ranks, chip_smoke.parallel_nccl,
        chip_smoke.parallel_rank, chip_smoke._parallel_steps, chip_smoke._parallel_account,
        chip_smoke._as_ranks, chip_smoke._adam_rule))
    assert not any(word in source for word in ("jax", "flax", "optax", "pathtracker_tpu"))
    assert 'backend="gloo"' in source and "launches_parallel" in source


def test_collective_activity_and_weight_gaps_read_what_they_say(tmp_path):
    import json

    import torch

    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"cat": "kernel", "name": "ncclDevKernel_AllReduce_Sum_f32_RING_LL"},
        {"cat": "kernel", "name": "k1_kernel"},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)"},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)"},
        {"cat": "cpu_op", "name": "nccl:all_reduce"}]}))
    assert chip_smoke._collective_activity(str(trace)) == (1, 1, 2)
    want = {"w": torch.zeros(4, 5), "n": torch.zeros((), dtype=torch.int64)}
    got = {"w": torch.zeros(4, 5), "n": torch.ones((), dtype=torch.int64)}
    got["w"][0, :3] = torch.tensor([1e-3, -3e-4, 2e-3])
    # The Adam rule: entry (0, 2)'s gradient is below a hundredth of the
    # largest, so only (0, 0) of the 19 clear entries counts against the atol.
    rms = {"w": torch.ones(4, 5)}
    rms["w"][0, 2] = 1e-3
    worst, share = chip_smoke._adam_rule(got, want, rms, 5e-4)
    assert abs(worst - 2e-3) < 1e-9 and abs(share - 1 / 19) < 1e-7


def test_model_parallel_phase_is_wired_before_the_kernels_line_and_its_ranks():
    """Phase 13 (i) runs after the resident phase and before the kernels
    line; ``chip_smoke.py --model-parallel-rank`` is one of its ranks,
    dispatched before the card check; it drives the dry run at 4 ranks and
    NCCL meshes of one, adds its launches to ``launches_parallel`` of the
    K1-K3 and the correlation rows, and imports nothing of JAX."""
    import inspect

    main = inspect.getsource(chip_smoke.main)
    assert main.index('"--model-parallel-rank"') < main.index("torch.cuda.is_available()")
    assert main.index("resident_phase(") < main.index("model_parallel_phase(") \
        < main.index('{"kernels"')
    assert "(i) model-parallel training" in chip_smoke.__doc__
    source = "".join(inspect.getsource(f) for f in (
        chip_smoke.model_parallel_phase, chip_smoke.model_parallel_rank,
        chip_smoke.model_parallel_nccl, chip_smoke._mp_steps, chip_smoke._as_data_ranks,
        chip_smoke._as_model_ranks, chip_smoke._as_space_ranks, chip_smoke._update_account))
    assert not any(word in source for word in ("jax", "flax", "optax", "pathtracker_tpu"))
    phase = inspect.getsource(chip_smoke.model_parallel_phase)
    assert "pathtracker_torch.parallel.dryrun" in phase and "correlation_rows" in phase
    assert phase.count('row["launches_parallel"] += count') == 2
    assert set(chip_smoke.MP_DRYRUN_MODES) >= {"fsdp step ok", "pp x dp pipeline step ok"}


def test_update_account_holds_step_one_tightly_and_later_steps_by_their_move():
    """The rntsm rule of phase 13 (i1) on hand-made runs: an update gap past
    the tolerance in three entries fails step 1 and passes at step 2; a
    step-2 loss off by a twentieth of its move fails."""
    import torch

    def run(deltas, losses):
        w = [{"p": torch.zeros(100)}]
        for d in deltas:
            w.append({"p": w[-1]["p"] + d})
        return {"weights": w, "losses": losses}

    base = torch.linspace(1, 2, 100)
    bent = base.clone()
    bent[:3] += 0.5  # three entries past 0.1 of the largest update (2)
    tol = chip_smoke.MP_RNTSM_TOL
    ref = run([base, base], [1.0, 0.9])
    assert chip_smoke._update_account(run([base, bent], [1.0, 0.9]), ref, tol)[1]
    assert not chip_smoke._update_account(run([bent, base], [1.0, 0.9]), ref, tol)[1]
    assert not chip_smoke._update_account(run([base, base], [1.0, 0.9 + 0.0051]), ref, tol)[1]
    assert chip_smoke._update_account(run([base, base], [1.0, 0.9 + 0.0049]), ref, tol)[1]
    assert not chip_smoke._update_account(run([base, base], [1.0 + 2e-5, 0.9]), ref, tol)[1]


def test_model_parallel_phase_holds_the_kernels_at_the_ranks_shapes():
    """Phase 13 (i) holds K1-K3 against their plain versions at the rows a
    rank of its dp x tp mesh (the whole batch) and of its dp x sp mesh (half
    of H) gives them, and the correlation kernels at a FSDP rank's frame
    pairs, beside the ranks' runs that launch them."""
    import inspect

    phase = inspect.getsource(chip_smoke.model_parallel_phase)
    assert "loop_shape_kernel_check(F, MP_INT_BATCH," in phase
    assert "loop_shape_kernel_check(F, MP_INT_BATCH // MP_RANKS," in phase
    assert "n = TSM_TRAIN_BATCH // MP_RANKS * (TIMESTEPS - 1)" in phase
    assert "correlation_errors(Co, *correlation_inputs(Co, n, SIDE, SIDE, CORR_C, PATCH" in phase
    side, ranks = chip_smoke.SIDE, chip_smoke.MP_RANKS
    # A space rank's rows of H are the rows of half the clips at full H.
    assert chip_smoke.MP_INT_BATCH * (side // ranks) * side \
        == chip_smoke.MP_INT_BATCH // ranks * side * side
    assert phase.index("loop_shape_kernel_check(") < phase.index("_as_model_ranks(")


STOP_SCRIPT = """\
import json, multiprocessing, os, subprocess, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke

chip_smoke.adopt_orphans()
# A child that ends at once and leaves a grandchild running: re-parented here.
out = subprocess.run(["sh", "-c", "sleep 300 >/dev/null 2>&1 & echo $!"],
                     capture_output=True, text=True, check=True).stdout
orphan = int(out)
with open(f"/proc/{orphan}/stat") as f:
    stat = f.read()
ppid = int(stat[stat.rindex(")") + 2:].split()[1])
# A spawn context's queue starts multiprocessing's resource tracker, which
# ignores SIGTERM and outlives no pipe.
queue = multiprocessing.get_context("spawn").SimpleQueue()
from multiprocessing import resource_tracker
tracker = resource_tracker._resource_tracker._pid
left = chip_smoke.stop_children()
print(json.dumps({"me": os.getpid(), "orphan": orphan, "ppid": ppid, "tracker": tracker,
                  "left": sorted(left), "after": sorted(chip_smoke._descendants()),
                  "orphan_gone": not os.path.exists(f"/proc/{orphan}")}))
"""


def test_stop_children_stops_orphans_and_the_resource_tracker(tmp_path):
    """What the script started and still runs at its end is stopped and
    reaped: a grandchild whose parent ended (found because the script is
    its subreaper) and the resource tracker a spawn pool starts."""
    import json
    import subprocess

    script = tmp_path / "stop.py"
    script.write_text(STOP_SCRIPT)
    proc = subprocess.run([sys.executable, str(script), ROOT], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["ppid"] == got["me"]
    assert got["tracker"] is not None
    assert {got["orphan"], got["tracker"]} <= set(got["left"])
    assert got["after"] == [] and got["orphan_gone"]


def test_main_stops_its_processes_before_the_kernels_line():
    """main makes the script its descendants' subreaper before it starts
    anything, stops them at exit, and stops and counts those left before
    the kernels line."""
    import inspect

    main = inspect.getsource(chip_smoke.main)
    order = [main.index(call) for call in (
        "adopt_orphans()", "atexit.register(_stop_children_at_exit)", "card_line()",
        "chain_phase(", "stop_children()", '{"kernels"')]
    assert order == sorted(order)
