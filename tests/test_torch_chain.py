"""The canonical warm-start chain and the matrix sweep with the port
(scripts/torch_reproduce_canonical.py, scripts/torch_eval_matrix.py)
against the JAX package's drivers (scripts/reproduce_canonical.sh,
scripts/eval_matrix.py) and its evaluate_model.

The chain runs at a tiny width on the CPU (dims 8, kernel 3, batch 8, 16 +
8 clips a root, one epoch a stage, windows of 2 steps, torch on one thread
in every process), twice (the command line, then the chain again without
its report): the stages' flags are read from the shell script's
run_stage lines, each warm start from the previous stage's best checkpoint,
the second invocation skips what is done. The matrix's accuracy on two
configs equals JAX's evaluate_model on the same roots and weights (one
batch a config: BatchNorm's batch statistics do not depend on the loaders'
order), its BCE within tests/test_torch_eval.py's atol 1e-3. From the
JAX package's own checkpoints, the port's crossovers kept from the card
read as the probe scored them. The stage steps from the JAX package's
checkpoints are tests/test_torch_chain_steps.py's."""

import contextlib
import glob
import gzip
import inspect
import io
import json
import os
import re
import shlex
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from pathtracker_torch.data import registry as tregistry
from pathtracker_torch.models.int_init import jax_int_params
from pathtracker_torch.train import checkpoint as tckpt
from pathtracker_torch.train import loop as tloop
from pathtracker_tpu.eval import test_model as jtm
from pathtracker_tpu.train import checkpoint as jckpt
from torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import torch_eval_matrix as matrix  # noqa: E402
import torch_reproduce_canonical as canon  # noqa: E402

KNOBS = {"BATCH": "8", "SYNTH_TRAIN": "16", "SYNTH_TEST": "8", "FUSED_STEPS": "2",
         "EPOCHS_A": "1", "EPOCHS_B": "1", "EPOCHS_C": "1", "EXTRA_FLAGS": "-d 8 -k 3"}
REPORT_SEEDS = (0,)  # the report's plumbing, not its numbers: one loader order
TAGS = ("A", "B", "C")
LOSS_ATOL = 1e-3
TIMEOUT = 300
WATCHED = ("results", "results_conv", "datasets")  # the repository's own run folders


def _snapshot():
    out = {}
    for top in WATCHED:
        for d, _, names in os.walk(os.path.join(ROOT, top)):
            for n in names:
                p = os.path.join(d, n)
                st = os.stat(p)
                out[p] = (st.st_size, st.st_mtime_ns)
    return out


def _env():
    env = dict(os.environ, **KNOBS, PATHTRACKER_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    env.pop("PATHTRACKER_DATA_ROOT", None)
    return env


def _drive(roots):
    """The chain's command line, to its end without the report (the
    report runs in this process, ``_report``)."""
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "torch_reproduce_canonical.py"),
         "--data-root", roots["data"], "--results-root", roots["results"], "--until", "C"],
        env=_env(), cwd=str(roots["cwd"]), capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "report:" not in proc.stdout
    return proc.stdout


def _report(roots) -> dict:
    """The report over the chain, in this process, with the environment
    main() sets, its held-out passes over REPORT_SEEDS in place of SEEDS."""
    with pytest.MonkeyPatch.context() as mp:
        for name, value in (("PATHTRACKER_DATA_ROOT", roots["data"]),
                            ("PATHTRACKER_DOT_SIZE", "2"),
                            ("PATHTRACKER_SYNTH_TRAIN", KNOBS["SYNTH_TRAIN"]),
                            ("PATHTRACKER_SYNTH_TEST", KNOBS["SYNTH_TEST"])):
            mp.setenv(name, value)
        mp.setattr(canon, "SEEDS", REPORT_SEEDS)
        with contextlib.redirect_stdout(io.StringIO()):
            return canon.report(roots["results"], dict(os.environ, **_env()))


def _chain_again(roots):
    """The chain alone, in this process (the report ran in the first)."""
    env = dict(_env(), PATHTRACKER_DATA_ROOT=roots["data"], PATHTRACKER_DOT_SIZE="2")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert canon.chain(roots["results"], env)
    return out.getvalue()


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chain")
    roots = {"data": str(tmp / "data"), "results": str(tmp / "results"),
             "cwd": tmp / "cwd"}
    roots["cwd"].mkdir()
    before = _snapshot()
    first = _drive(roots)
    hp = {tag: {k: str(v) for k, v in np.load(os.path.join(
        canon.run_folder(roots["results"], tag, canon.knobs(KNOBS)), "hp_dict.npz")).items()}
        for tag in TAGS}
    done = {tag: _files(canon.run_folder(roots["results"], tag, canon.knobs(KNOBS)))
            for tag in "AB"}
    report = _report(roots)
    second = _chain_again(roots)
    return dict(tmp=tmp, roots=roots, first=first, report=report, second=second, hp=hp,
                done=done, before=before, after=_snapshot())


def _files(folder):
    return {os.path.join(d, n): os.stat(os.path.join(d, n)).st_mtime_ns
            for d, _, names in os.walk(folder) for n in names}


def _stage_argv(output: str, tag: str) -> list[str]:
    line = next(line for line in output.splitlines() if line.startswith(f"chain: [{tag}] /"))
    argv = shlex.split(line.split("] ", 1)[1])
    assert argv[1:4] == ["-u", "-m", "pathtracker_torch.train"]
    return argv[4:]


def _shell_stages(ckpts: dict) -> dict:
    """Each run_stage line of scripts/reproduce_canonical.sh with the
    knobs, the port's results folder and ``ckpts`` (the checkpoint each
    command substitution gives, None for none) put in."""
    with open(os.path.join(ROOT, "scripts", "reproduce_canonical.sh")) as f:
        text = f.read().replace("\\\n", " ")
    values = dict(canon.KNOBS, **KNOBS, MODEL="InT", PFX="")
    stages = {}
    for line in text.splitlines():
        m = re.match(r"\s*run_stage \$\{PFX\}(\w) mainclean\.py (.*)\|\| exit 1\s*$", line)
        if not m:
            continue
        tag, cmd = m.groups()
        # The command substitutions: best_ckpt, and C's "--ckpt only while undone".
        cmd = re.sub(r'\$\(stage_done "\$C" \|\| echo --ckpt "\$\(best_ckpt "\$B"\)"\)',
                     "@OPTCKPT@", cmd)
        cmd = re.sub(r'"\$\(best_ckpt "\$\w"\)"', "@CKPT@", cmd)
        cmd = re.sub(r"\$\{(\w+):-([^}]*)\}", lambda g: values.get(g[1], g[2]), cmd)
        cmd = re.sub(r"\$\{?(\w+)\}?", lambda g: values[g[1]], cmd)
        argv = []
        for word in shlex.split(cmd):
            if word == "@OPTCKPT@":
                argv += ["--ckpt", ckpts[tag]] if ckpts[tag] else []
            else:
                argv.append(ckpts[tag] if word == "@CKPT@" else word)
        stages[tag] = argv
    assert sorted(stages) == list(TAGS)
    return stages


def test_stage_flags_are_the_shell_scripts(chain):
    results = chain["roots"]["results"]
    k = canon.knobs(KNOBS)
    best = {tag: jckpt.find_best_checkpoint(canon.run_folder(results, tag, k))
            for tag in "AB"}
    for output, ckpts in ((chain["first"], {"A": None, "B": best["A"], "C": best["B"]}),
                          (chain["second"], {"C": None})):
        want = _shell_stages(dict({"A": None, "B": None}, **ckpts))
        for tag in ckpts:
            got = _stage_argv(output, tag)
            shell = [os.path.join(results, "results_conv") if w == "results_conv" else w
                     for w in want[tag]]
            assert got == shell, (tag, got, shell)


def test_three_run_folders_with_the_jax_artifacts(chain):
    k = canon.knobs(KNOBS)
    for tag in TAGS:
        folder = canon.run_folder(chain["roots"]["results"], tag, k)
        assert sorted(os.listdir(folder)) == sorted(
            ["hp_dict.npz", "saved_models", f"chain{tag}.txt", "train.npz", "val.npz"])
        val = np.load(os.path.join(folder, "val.npz"))
        assert sorted(val.files) == ["balacc", "f1score", "loss", "precision", "recall"]
        assert len(val["balacc"]) == 1 and canon.stage_done(folder)
        assert chain["hp"][tag]["exp_name"] == f"chain{tag}"


def test_each_stage_starts_from_the_previous_best(chain):
    """B and C load exactly the checkpoint the JAX driver's best_ckpt
    picks in the previous stage's folder: same file, equal state dicts."""
    k = canon.knobs(KNOBS)
    assert chain["hp"]["A"]["loaded_ckpt"] == "None"
    for prev, tag in (("A", "B"), ("B", "C")):
        folder = canon.run_folder(chain["roots"]["results"], prev, k)
        want = jckpt.find_best_checkpoint(folder)
        loaded = chain["hp"][tag]["loaded_ckpt"]
        assert loaded == want == canon.best_checkpoint(folder)
        ours, theirs = tckpt.load_params(loaded), jckpt.load_params(want)
        assert sorted(ours) == sorted(theirs)
        for name in theirs:
            np.testing.assert_array_equal(np.asarray(ours[name]), np.asarray(theirs[name]))


def test_second_invocation_skips_finished_stages(chain):
    second = chain["second"]
    k = canon.knobs(KNOBS)
    for tag in "AB":
        assert f"chain: [{tag}] done" in second
        assert not any(line.startswith(f"chain: [{tag}] /") for line in second.splitlines())
        folder = canon.run_folder(chain["roots"]["results"], tag, k)
        assert _files(folder) == chain["done"][tag]
    assert "--ckpt" not in _stage_argv(second, "C")  # its own rolling checkpoint
    assert "chain: [C] exit 0" in second and "chain: done" in second


def test_report_and_nothing_written_outside_the_roots(chain):
    """The report has each stage's curve and B's, C's and the JAX chainB
    and chainC checkpoints' held-out numbers, each the mean of its seeded
    passes (REPORT_SEEDS here); the chain and the report wrote only under
    their two roots."""
    report = chain["report"]
    for tag in TAGS:
        assert report["stages"][tag]["curve"]["epochs"] == 1
        assert report["stages"][tag]["jax_curve"]["epochs"] > 1
    for row in (report["stages"]["B"]["held_out"], report["stages"]["C"]["held_out"],
                report["jax_chainB"], report["jax_chainC"]):
        assert 0.0 <= row["acc"] <= 1.0 and np.isfinite(row["loss"])
        assert [s["seed"] for s in row["seeded"]] == list(REPORT_SEEDS)
    assert report["stages"]["A"]["jax_curve"]["first_above_75"] == 44
    assert chain["before"] == chain["after"]
    assert sorted(os.listdir(chain["tmp"])) == ["cwd", "data", "results"]
    assert os.listdir(chain["roots"]["cwd"]) == []
    assert sorted(os.listdir(chain["roots"]["results"])) == ["logs", "results",
                                                             "results_conv"]
    assert sorted(os.listdir(chain["roots"]["data"])) == [
        "pathtracker_32_32_32", "pathtracker_64_32_32", "pathtracker_8_32_32"]


# --------------------------------- matrix -----------------------------------

T_BATCH = 8
COMPARED = [(14, 1, 32), (14, 1, 64)]
UNRENDERED = (0, 1, 64)  # left for the driver's render_missing


@pytest.fixture(scope="module")
def matrix_run(tmp_path_factory):
    """All configs rendered (one batch of test clips each) but UNRENDERED,
    a checkpoint of InT's seeded init written by the JAX package (the draw
    of its ``init_model``, which tests/test_torch_int_init.py holds
    models/int_init.py to, without JAX's eager init), and the sweep's
    output."""
    tmp = tmp_path_factory.mktemp("matrix")
    args = types.SimpleNamespace(model="InT", batch_size=T_BATCH, dimensions=8,
                                 fb_kernel_size=3, pretrained=False, algo="Testing",
                                 penalty="Testing", seed=0, bf16=True, parallel=True,
                                 ckpt=str(tmp / "init.pth.tar"))
    jckpt.save_checkpoint(args.ckpt, jax_int_params(args.seed, 8, 3, 8))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PATHTRACKER_DATA_ROOT", str(tmp / "data"))
        mp.setenv("PATHTRACKER_SYNTH_TRAIN", str(T_BATCH))
        mp.setenv("PATHTRACKER_SYNTH_TEST", str(T_BATCH))
        mp.setenv("PATHTRACKER_DOT_SIZE", "2")
        mp.setenv("PATHTRACKER_TORCH_DEVICE", "cpu")
        for d in matrix.configs():
            key = (d["dist"], d["speed"], d["length"])
            if key != UNRENDERED:
                tregistry.dataset_selector(*key)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            results = matrix.main([args.ckpt, str(tmp / "out"), "InT", "-b", str(T_BATCH),
                                   "-d", "8", "-k", "3"])
    return dict(tmp=tmp, args=args, results=results, lines=out.getvalue().splitlines())


def test_matrix_visits_every_config_t64_first(matrix_run):
    visited = [tuple(int(v) for v in re.findall(r"=(\d+)", line))
               for line in matrix_run["lines"] if line.startswith("=== config")]
    assert visited == list(matrix_run["results"])
    assert sorted(visited) == sorted((d["dist"], d["speed"], d["length"])
                                     for d in tregistry.ALL_DATASETS)
    lengths = [key[2] for key in visited]
    assert lengths == sorted(lengths, key=lambda t: (t != 64, t)) and lengths[0] == 64
    assert "MATRIX COMPLETE" in matrix_run["lines"]
    for key, (acc, loss) in matrix_run["results"].items():
        saved = np.load(os.path.join(matrix_run["tmp"], "out",
                                     "test_perf_dist_{}_speed_{}_length_{}.npz".format(*key)))
        assert (float(saved["arr_0"]), float(saved["arr_1"])) == (acc, loss)


def test_matrix_renders_a_missing_config_as_the_registry(matrix_run, tmp_path, monkeypatch):
    monkeypatch.setenv("PATHTRACKER_DATA_ROOT", str(tmp_path))
    monkeypatch.setenv("PATHTRACKER_SYNTH_TRAIN", str(T_BATCH))
    monkeypatch.setenv("PATHTRACKER_SYNTH_TEST", str(T_BATCH))
    monkeypatch.setenv("PATHTRACKER_DOT_SIZE", "2")
    want = tregistry.dataset_selector(*UNRENDERED)[0]
    got = want.replace(str(tmp_path), str(matrix_run["tmp"] / "data"))
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    for name in os.listdir(want):
        with open(os.path.join(got, name), "rb") as a, open(os.path.join(want, name),
                                                              "rb") as b:
            assert gzip.decompress(a.read()) == gzip.decompress(b.read()), name
    assert not [n for n in os.listdir(matrix_run["tmp"]) if n.startswith("data.render")]


@pytest.mark.parametrize("key", COMPARED, ids=lambda k: "T{}".format(k[2]))
def test_matrix_matches_jax_evaluate_model(matrix_run, monkeypatch, key):
    monkeypatch.setenv("PATHTRACKER_DATA_ROOT", str(matrix_run["tmp"] / "data"))
    dist, speed, length = key
    jacc, jloss = jtm.evaluate_model(str(matrix_run["tmp"] / "jax"), matrix_run["args"],
                                     prep_gifs=0, dist=dist, speed=speed, length=length)
    acc, loss = matrix_run["results"][key]
    assert acc == jacc
    assert abs(loss - jloss) <= LOSS_ATOL, (loss, jloss)


# ------------------------------ cells, --transfer A --------------------------

import torch_chain_probe as probe  # noqa: E402

CELL_KNOBS = {"BATCH": "4", "SYNTH_TRAIN": "8", "SYNTH_TEST": "4", "FUSED_STEPS": "2",
              "EPOCHS_A": "1", "EPOCHS_B": "1", "EPOCHS_C": "1",
              "EXTRA_FLAGS": "-d 32 -k 3"}  # 32 channels: the width the kernels take


def test_eager_cell_builds_int_without_the_kernels_in_every_stage(tmp_path, monkeypatch):
    """Each stage of a CELL=eager chain, as its stage process runs it
    (``stage_run``), builds InT with ``use_fused`` False; the same stage on
    the fused cell builds it with ``use_fused`` True."""
    monkeypatch.setenv("PATHTRACKER_DATA_ROOT", str(tmp_path / "data"))
    monkeypatch.setenv("PATHTRACKER_DOT_SIZE", "2")
    monkeypatch.setenv("PATHTRACKER_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("PATHTRACKER_LAUNCHES", raising=False)
    built = []
    real = tloop.init_model

    def spy(*a, **kw):
        model = real(*a, **kw)
        built.append((type(model).__name__, model.use_fused, kw))
        return model

    monkeypatch.setattr(tloop, "init_model", spy)
    results = str(tmp_path / "results")
    for cell_name in ("eager", "fused"):
        k = canon.knobs(dict(CELL_KNOBS, CELL=cell_name))
        previous = None
        for tag in (TAGS if cell_name == "eager" else "A"):
            ckpt = canon.best_checkpoint(previous) if previous else None
            assert canon.stage_run(cell_name, canon.stage_flags(tag, k, results, ckpt)) == 0
            previous = canon.run_folder(results, tag, k)
            assert canon.stage_done(previous)
    assert [b[:2] for b in built] == [("InT", False)] * 3 + [("InT", True)]
    assert [b[2].get("fused") for b in built] == [False] * 3 + [None]
    assert os.path.basename(canon.run_folder(results, "C", canon.knobs({"CELL": "eager"}))) \
        == "eager_chainC"


def test_eager_chain_runs_its_stages_through_the_stage_runner(tmp_path):
    """CELL=eager: the chain script runs a stage as a process of itself
    (``--stage-run eager`` and the stage's flags: the train CLI has no flag
    for the cell), its run folder, log and name carry ``eager_``, and
    ``--until A`` stops after A without the report."""
    env = dict(_env(), CELL="eager")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "torch_reproduce_canonical.py"),
         "--data-root", str(tmp_path / "data"), "--results-root", str(tmp_path / "results"),
         "--until", "A"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = next(x for x in proc.stdout.splitlines() if x.startswith("chain: [eager_A] /"))
    argv = shlex.split(line.split("] ", 1)[1])
    assert argv[1:4] == ["-u", os.path.join(ROOT, "scripts", "torch_reproduce_canonical.py"),
                         "--stage-run"]
    k = canon.knobs(env)
    assert argv[4:] == ["eager", *canon.stage_flags("A", k, str(tmp_path / "results"))]
    assert "--name" in argv and argv[argv.index("--name") + 1] == "eager_chainA"
    assert proc.stdout.strip().splitlines()[-1] == "chain: stopped after stage A"
    assert canon.stage_done(canon.run_folder(str(tmp_path / "results"), "A", k))
    assert os.path.exists(tmp_path / "results" / "logs" / "eager_A.log")
    assert not os.path.exists(canon.run_folder(str(tmp_path / "results"), "B", k))


def test_probe_and_chain_share_the_cells(tmp_path):
    """The probe's variants take their flags and model keywords from the
    chain's ``cell``: eager is ``fused=False`` with --bf16 in both, f32
    drops --bf16, fused sets nothing; the chain takes fused or eager."""
    for base, kwargs, bf16 in (("fused", {}, True), ("eager", {"fused": False}, True),
                               ("f32", {}, False)):
        flags, got = probe._flags("A", base, 1, None, str(tmp_path))
        assert got == kwargs and ("--bf16" in flags) == bf16, base
        want = canon.stage_flags("A", dict(canon.knobs(), EPOCHS_A="1"),
                                 os.path.join(probe.OUT, "A", base))
        want[want.index("--name") + 1] = f"probe_{base}"
        assert (flags, got) == canon.cell(base, want)
        flags, got = probe._flags("A", f"{base}+s2", 1, None, str(tmp_path))
        assert got == dict(kwargs, seed=2)
    assert canon.cell("eager", ["--bf16"]) == (["--bf16"], {"fused": False})
    assert canon.knobs({"CELL": "eager"})["PFX"] == "eager_"
    assert canon.knobs({})["PFX"] == "" and canon.knobs({})["CELL"] == "fused"
    for bad in ({"CELL": "f32"}, {"CELL": "nope"}, {"CELL": "eager", "MODEL": "hgru"}):
        with pytest.raises(ValueError):
            canon.knobs(bad)
    with pytest.raises(ValueError):
        probe._flags("A", "nope", 1, None, str(tmp_path))


def test_transfer_a_takes_the_jax_chain_a_from_its_last_plateau_epoch():
    names = canon.checkpoints(canon.JAX_CHAIN_A, canon.JAX_A_EPOCHS)
    assert [canon._epoch(n) for n in names] == [38, 44, 45, 46, 47, 49, 56, 59]
    assert canon.curve(os.path.join(canon.JAX_CHAIN_A, "val.npz"))["first_above_75"] == 44


def test_transfer_a_scores_every_a_checkpoint_on_both_shards(chain, monkeypatch):
    """``--transfer A`` over the chain: every stage-A checkpoint of the
    chain (its best-val ones and the rolling one) and the JAX package's
    chainA checkpoints (here the last of JAX_A_EPOCHS) each scored on B's
    and C's held-out shards (under loader seed 0 here, for time; 0-2 by
    default), with its epoch after the escape; and the A checkpoint each B
    started from, as B's hp_dict.npz names it (the JAX package's chainB:
    A's epoch 59, 15 epochs after its escape at 44). The report names B's
    start too."""
    monkeypatch.setattr(canon, "JAX_A_EPOCHS", (59,))
    assert inspect.signature(canon.transfer_a).parameters["seeds"].default == (0, 1, 2)
    roots = chain["roots"]
    # The scripts read the data root from the environment, as their main() sets it.
    for name, value in (("PATHTRACKER_DATA_ROOT", roots["data"]), ("PATHTRACKER_DOT_SIZE", "2"),
                        ("PATHTRACKER_SYNTH_TRAIN", KNOBS["SYNTH_TRAIN"]),
                        ("PATHTRACKER_SYNTH_TEST", KNOBS["SYNTH_TEST"])):
        monkeypatch.setenv(name, value)
    env = dict(os.environ, **_env())
    before = _snapshot()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = canon.transfer_a(roots["results"], env, seeds=canon.SEEDS[:1])
    k = canon.knobs(KNOBS)
    saved = os.path.join(canon.run_folder(roots["results"], "A", k), "saved_models")
    assert sorted(got["port"]["checkpoints"]) == sorted(os.listdir(saved))
    assert sorted(got["jax"]["checkpoints"]) == [
        "model_val_acc_0099_epoch_59_checkpoint.pth.tar"]
    for who in ("port", "jax"):
        for name, row in got[who]["checkpoints"].items():
            for tag in ("B", "C"):
                assert [s["seed"] for s in row[tag]["seeded"]] == [0], (who, name)
                assert 0.0 <= row[tag]["acc"] <= 1.0 and np.isfinite(row[tag]["loss"])
            assert f"report: transfer A [{who}] {name} (epoch {row['epoch']}," in out.getvalue()
    assert got["jax"]["checkpoints"]["model_val_acc_0099_epoch_59_checkpoint.pth.tar"][
        "after_escape"] == 15
    assert got["jax"]["b_started_from"] == {
        "ckpt": "model_val_acc_0099_epoch_59_checkpoint.pth.tar", "b_ran": True, "epoch": 59,
        "escape": 44, "after_escape": 15}
    start = got["port"]["b_started_from"]
    assert start["b_ran"] and start["ckpt"] == os.path.basename(chain["hp"]["B"]["loaded_ckpt"])
    assert start["epoch"] == 0 and start["ckpt"] in got["port"]["checkpoints"]
    assert f"report: transfer A [port] B started from {start['ckpt']}" in out.getvalue()
    report = chain["report"]
    assert report["stages"]["B"]["started_from"] == start
    assert _snapshot() == before


# ------------------- the JAX chainC under the report's passes ---------------

JAX_C_EPOCHS = [0, 1, 4, 5, 6, 8, 12, 22, 32, 34]


def test_jax_records_are_the_eval_folders_npz():
    """The JAX package's held-out record of each of its chainC checkpoints
    (results/chainC_eval_*) and of the chainB checkpoint C loaded, by epoch."""
    c = canon.jax_records("C")
    assert list(c) == JAX_C_EPOCHS
    assert (round(100 * c[0]["acc"], 2), round(100 * c[34]["acc"], 2)) == (64.27, 68.05)
    saved = np.load(canon.RECORDS["C"]["npz"])
    assert c[34] == {"acc": float(saved["arr_0"]), "loss": float(saved["arr_1"])}
    assert list(canon.jax_records("B")) == [23] and canon.jax_records("A") == {}


def test_report_scores_the_jax_chainc_checkpoint_as_held_out(chain, monkeypatch):
    """The report's ``jax_chainC`` is ``held_out``'s result for the JAX
    package's chainC epoch-34 checkpoint at its width on C's shard: a
    seeded pass of it again in this process is the report's, and the
    verdicts say where it stands against its record and the bar."""
    report = chain["report"]
    got = report["jax_chainC"]
    assert got["ckpt"] == os.path.relpath(canon.JAX_CHAIN_C, ROOT)
    assert canon._epoch(got["ckpt"]) == 34 and got["clips"] == int(KNOBS["SYNTH_TEST"])
    monkeypatch.setenv("PATHTRACKER_DATA_ROOT", chain["roots"]["data"])
    monkeypatch.setenv("PATHTRACKER_DOT_SIZE", "2")
    args = canon._eval_args(canon.knobs(KNOBS), chain["roots"]["results"], "C", "cpu",
                            canon.JAX_CHAIN_C, jax=True)
    assert (args.dimensions, args.fb_kernel_size, args.batch_size) == (32, 7, 8)
    again = canon.seeded_passes(args, 14, 64, (0,))["seeded"][0]
    assert again["acc"] == got["seeded"][0]["acc"]
    np.testing.assert_allclose(again["loss"], got["seeded"][0]["loss"], rtol=1e-6)
    verdicts = report["verdicts"]
    record = canon.jax_records("C")[34]["acc"]
    bar = min(record, *canon.RECORDS["C"]["other_runs"]) - canon.MARGIN
    assert round(100 * bar, 2) == 66.05
    assert verdicts["jax_chainC_above_bar"] == (got["acc"] >= bar)
    lo, hi = got["acc_range"]
    assert verdicts["jax_chainC_in_spread"] == (lo <= record <= hi)


def _stub_held_out(calls):
    def held_out(args, dist, length, folder):
        calls.append((args.ckpt, args.dimensions, args.fb_kernel_size, dist, length))
        seeded = [{"seed": s, "acc": 0.5, "loss": 0.7, "batches": 1} for s in canon.SEEDS]
        return {"ckpt": args.ckpt, "acc": 0.5, "loss": 0.7, "seeded": seeded,
                "unseeded": {"acc": 0.5, "loss": 0.7}, "acc_range": [0.5, 0.5],
                "loss_range": [0.7, 0.7], "clips": 8, "seconds": 0.0}
    return held_out


def test_jax_curve_visits_the_ten_jax_checkpoints_in_epoch_order(tmp_path, monkeypatch):
    """``--report --jax-curve C`` scores the JAX package's chainC
    checkpoints through ``held_out`` at its width on C's shard, epochs 0 to
    34 in order, each beside its record; the report's ``jax_chainC`` is the
    curve's epoch 34, not scored again; then the JAX chainB checkpoint."""
    calls = []
    monkeypatch.setattr(canon, "held_out", _stub_held_out(calls))
    for name in ("PATHTRACKER_DATA_ROOT", "PATHTRACKER_DOT_SIZE", "PATHTRACKER_SYNTH_TRAIN",
                 "PATHTRACKER_SYNTH_TEST"):  # main() sets them; restored after
        monkeypatch.setenv(name, "")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert canon.main(["--report", "--jax-curve", "C",
                           "--results-root", str(tmp_path / "results"),
                           "--data-root", str(tmp_path / "data")]) == 0
    folder = os.path.dirname(canon.JAX_CHAIN_C)
    assert [c[0] for c in calls] == [
        *(os.path.join(folder, n) for n in sorted(os.listdir(folder), key=canon._epoch)),
        canon.JAX_CHAIN_B]
    assert {c[1:] for c in calls[:-1]} == {(32, 7, 14, 64)} and calls[-1][1:] == (32, 7, 5, 32)
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    curve = report["jax_curve"]
    assert curve["stage"] == "C"
    records = canon.jax_records("C")
    assert [r["epoch"] for r in curve["checkpoints"].values()] == JAX_C_EPOCHS
    for row in curve["checkpoints"].values():
        assert row["record"] == records[row["epoch"]]
        assert len(row["seeded"]) == len(canon.SEEDS)
        assert f"report: JAX chainC epoch {row['epoch']}: 50.00%" in out.getvalue()
    assert report["jax_chainC"] == curve["checkpoints"][os.path.basename(canon.JAX_CHAIN_C)]
    assert "its record 68.05% outside the spread; the bar 66.05%" in out.getvalue()
    assert not os.path.exists(tmp_path / "data")


def test_probe_heldout_scores_every_best_val_checkpoint_under_all_seeds(chain, tmp_path,
                                                                        monkeypatch):
    """``torch_chain_probe.py --stage C --heldout`` over a variant's run
    (here the chain's stage C, from its B, at dims 8, put where the probe
    keeps the run of ``fused``, and ``--score-only``: nothing trained, the
    run's files untouched, no exit code or seconds): every
    ``model_val_acc_*`` checkpoint scored on C's held-out shard under all
    ten loader seeds, each with its epoch and the JAX package's record at
    that epoch, the best-val one named (the one the chain's next stage
    would load); one line each, and the scores in the JSON line."""
    for name, value in dict(KNOBS, PATHTRACKER_DATA_ROOT=chain["roots"]["data"],
                            PATHTRACKER_DOT_SIZE="2", PATHTRACKER_TORCH_DEVICE="cpu").items():
        monkeypatch.setenv(name, value)
    folder = os.path.join(tmp_path, "C", "fused", "results_conv", "64_1_14", "probe_fused")
    run = canon.run_folder(chain["roots"]["results"], "C", canon.knobs(KNOBS))
    shutil.copytree(run, folder, copy_function=shutil.copy)  # the files' times not kept
    files = _files(folder)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = probe.main(["--stage", "C", "--epochs", "1", "--variants", "fused", "--heldout",
                         "--score-only", "--results-root", chain["roots"]["results"],
                         "--out", str(tmp_path)])
    assert rc == 0, out.getvalue()[-3000:]
    variant = json.loads(out.getvalue().strip().splitlines()[-1])["variants"]["fused"]
    assert variant["rc"] is None and variant["seconds"] is None
    assert variant["curve"]["epochs"] == 1 and "probe: [fused] not run" in out.getvalue()
    row = variant["heldout"]
    names = sorted(n for n in os.listdir(os.path.join(folder, "saved_models"))
                   if n.startswith("model_val_acc_"))
    assert names and sorted(row["checkpoints"]) == names
    assert row["best"] == os.path.basename(canon.best_checkpoint(run))
    records = canon.jax_records("C")
    for name, got in row["checkpoints"].items():
        assert [s["seed"] for s in got["seeded"]] == list(canon.SEEDS)
        assert 0.0 <= got["acc"] <= 1.0 and np.isfinite(got["loss"])
        assert got["epoch"] == canon._epoch(name) and got["record"] == records.get(got["epoch"])
        assert f"probe: held-out [fused] epoch {got['epoch']}" in out.getvalue()
    assert records[0] in [got["record"] for got in row["checkpoints"].values()]
    assert _files(folder) == files


@pytest.mark.parametrize("chain_dir", sorted(
    d for d in os.listdir(os.path.join(ROOT, "results_torch")) if d.startswith("chain_"))
    if os.path.isdir(os.path.join(ROOT, "results_torch")) else [])
def test_kept_card_chains_are_what_the_report_reads(chain_dir):
    """A chain kept from the card (results_torch/chain_<cell>_<n>: stage
    logs, npz logs, each stage's best-val checkpoint) reads as a finished
    chain of its cell: every stage done with its full val curve, its best
    checkpoint the one kept, and each B and C started from the checkpoint
    kept in the stage before."""
    results = os.path.join(ROOT, "results_torch", chain_dir)
    k = canon.knobs({"CELL": chain_dir.split("_")[1]})
    kept = {}
    for tag in TAGS:
        folder = canon.run_folder(results, tag, k)
        assert canon.stage_done(folder), folder
        epochs = int(np.load(os.path.join(folder, "hp_dict.npz"))["epochs"])
        assert epochs == int(k[canon.STAGES[tag][3][0]]) or tag == "C"  # C's cut to fit the card
        assert canon.curve(os.path.join(folder, "val.npz"))["epochs"] == epochs
        names = canon.checkpoints(folder)
        assert len(names) == 1 and canon.best_checkpoint(folder).endswith(names[0])
        assert os.path.exists(os.path.join(results, "logs", f"{k['PFX']}{tag}.log"))
        kept[tag] = names[0]
    start = canon.started_from(canon.run_folder(results, "B", k),
                               canon.run_folder(results, "A", k))
    assert start["b_ran"] and start["ckpt"] == kept["A"] and start["after_escape"] >= 0
    loaded = np.load(os.path.join(canon.run_folder(results, "C", k), "hp_dict.npz"))
    assert os.path.basename(str(loaded["loaded_ckpt"])) == kept["B"]


# The JAX package's checkpoints the stage steps (tests/test_torch_chain_steps.py)
# and the crossovers start from.
JAX_STARTS = {"A": os.path.join(canon.JAX_CHAIN_A, "saved_models",
                                "model_val_acc_0056_epoch_38_checkpoint.pth.tar"),
              "B": os.path.join(canon.JAX_CHAIN_A, "saved_models",
                                "model_val_acc_0099_epoch_59_checkpoint.pth.tar"),
              "C": canon.JAX_CHAIN_B}
CROSS_STARTS = {"B": JAX_STARTS["B"], "C": canon.JAX_CHAIN_B}  # the JAX starts crossed from


@pytest.mark.parametrize("cross_dir", sorted(
    d for d in os.listdir(os.path.join(ROOT, "results_torch")) if d.startswith("cross_"))
    if os.path.isdir(os.path.join(ROOT, "results_torch")) else [])
def test_kept_crossovers_are_what_the_probe_scored(cross_dir):
    """A crossover kept from the card (results_torch/cross_<stage>_<cell>:
    the probe's output and the stage's log, the npz logs, the best-val
    checkpoint): the stage at the chain's width started from the JAX
    package's checkpoint of the stage before, or from a kept crossover of
    that stage; its val curve one entry an epoch; the kept checkpoint the
    one the val curve's best epoch saved, which the probe's JSON line
    names best-val and scored under all ten loader seeds."""
    _, stage, cell, *_ = cross_dir.split("_")
    results = os.path.join(ROOT, "results_torch", cross_dir)
    length, dist, _, _ = canon.STAGES[stage]
    variant = f"{cell}+ckpt"
    folder = os.path.join(results, "results_conv", f"{length}_1_{dist}", f"probe_{variant}")
    hp = np.load(os.path.join(folder, "hp_dict.npz"))
    assert (int(hp["dimensions"]), int(hp["fb_kernel_size"]), int(hp["timesteps"])) == (
        32, 7, length)
    kept_before = glob.glob(os.path.join(ROOT, "results_torch",
                                         f"cross_{probe.PREVIOUS[stage]}_*", "results_conv",
                                         "*", "*", "saved_models", "*.tar"))
    assert os.path.basename(str(hp["loaded_ckpt"])) in {
        os.path.basename(CROSS_STARTS[stage]), *map(os.path.basename, kept_before)}
    val = np.load(os.path.join(folder, "val.npz"))["balacc"]
    assert len(val) == int(hp["epochs"])
    names = canon.checkpoints(folder)
    assert len(names) == 1 and val[canon._epoch(names[0])] == val.max()
    with open(os.path.join(results, "logs", "probe.log")) as f:
        probe_out = f.read()
    assert os.path.exists(os.path.join(results, "logs", f"{variant}.log"))
    line = json.loads(probe_out.strip().splitlines()[-1])
    held = line["variants"][variant]["heldout"]
    assert held["best"] == names[0]
    assert [s["seed"] for s in held["checkpoints"][names[0]]["seeded"]] == list(canon.SEEDS)

