"""The port's training loop (python -m pathtracker_torch.train) against the
JAX package's: one run of each on the same tiny root, the same JAX-seeded
init checkpoint, the same argv and the same batch order, then the loop's
features on the port alone (auto-resume, SIGTERM, the optimizer flags,
--profile, the later-slice flags, rntsm).

Tolerances. Per-step train losses and per-epoch val losses within 1e-3,
the f32 tolerance of tests/test_int_parity.py:93-129. Balanced accuracies
exactly: a sign flip of one logit would move them by whole clips.

The weights and Adam's moments after the run, by tests/test_torch_tsm_steps.py's
rule. Adam's update is lr*m/(sqrt(v)+eps): sign-like where a gradient sits
at rounding distance from zero, so there the packages may move an entry by
up to lr in opposite directions each step, and every entry is held within
2*lr a step. Where the gradients stand clear of rounding (the RMS gradient,
sqrt(nu) of the JAX run's Adam state, above CUT times its parameter's
largest), the update is held within 0.1*lr of JAX's, but for at most FLIPS
entries a parameter. The moments themselves, the two packages' sums of the
same f32 gradients, are held relative to their parameter's largest entry:
at most FLIPS entries past MOMENT_GAP, and a mean gap under a tenth of it
(measured: at most 7.1e-4 and 9.9e-5, in w_exc)."""

import functools
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from pathtracker_torch import engine as tengine
from pathtracker_torch.data import native as tnative
from pathtracker_torch.models import tsm_resnet as TM
from pathtracker_torch.train import checkpoint as tckpt
from pathtracker_torch.train import loop as tloop
from pathtracker_torch.train.torch_import import state_dict_from_jax, to_jax_params
from pathtracker_torch.utils.opts import parser as tparser
from pathtracker_tpu.data import native as jnative
from pathtracker_tpu.models import tsm_resnet as JM
from pathtracker_tpu.train import checkpoint as jckpt
from pathtracker_tpu.train import loop as jloop
from pathtracker_tpu.train.steps import make_optimizer as jmake_optimizer
from pathtracker_tpu.utils.opts import parser as jparser

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_ATOL, LR, STEPS, EPOCHS = 1e-3, 3e-4, 2, 2
FLIPS, CUT, MOMENT_GAP = 2, 5e-2, 1e-2
ROLLING = os.path.join("saved_models", "model_last_epoch_checkpoint.pth.tar")
CLIPS = 8  # per split: 2 train steps of 4, 2 val batches
ARGV = ["--model", "InT", "--name", "run", "--length", "8", "--speed", "1",
        "--dist", "1", "-b", "4", "-d", "4", "-k", "3", "--lr", str(LR),
        "--print-freq", "1"]


def _same_order(mp):
    """Both packages' loaders on one batch order: the native one where the
    port's library builds (the JAX binding pointed at it), else Python."""
    if tnative.available():
        mp.setattr(jnative, "_SO_PATHS", [str(tnative.library_path())])
        mp.setattr(jnative, "_TRIED", False)
        mp.setattr(jnative, "_LIB", None)
        assert jnative.available()
    else:
        mp.setattr(jnative, "available", lambda: False)


def _port_args(argv, **extra):
    args = tparser.parse_args(argv)
    args.device = "cpu"
    for k, v in extra.items():
        setattr(args, k, v)
    return args


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One tiny root, a checkpoint of the JAX package's seeded init, and one
    run of each package's main from it on the same argv."""
    tmp = tmp_path_factory.mktemp("loop")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PATHTRACKER_DATA_ROOT", str(tmp / "data"))
        mp.setenv("PATHTRACKER_SYNTH_TRAIN", str(CLIPS))
        mp.setenv("PATHTRACKER_SYNTH_TEST", str(CLIPS))
        _same_order(mp)
        init = str(tmp / "init.pth.tar")
        params = jloop.init_model(SimpleNamespace(
            model="InT", dimensions=4, fb_kernel_size=3, seed=0, bf16=False,
            algo="bptt", pretrained=False), 8)[1]["params"]
        jckpt.save_checkpoint(init, params)
        argv = ARGV + ["--epochs", str(EPOCHS), "--ckpt", init]
        out = {"tmp": tmp, "init": init, "argv": argv, "template": params}
        out["jax"] = jloop.main(jparser.parse_args(
            argv + ["--results-dir", str(tmp / "jax")]), max_steps_per_epoch=STEPS)
        out["torch"] = tloop.main(_port_args(
            argv + ["--results-dir", str(tmp / "torch")]), max_steps_per_epoch=STEPS)
        yield out


def _files(folder):
    return sorted(os.path.relpath(os.path.join(d, n), folder)
                  for d, _, names in os.walk(folder) for n in names)


def _npz(folder, name):
    with np.load(os.path.join(folder, name + ".npz"), allow_pickle=True) as f:
        return {k: f[k] for k in f.files}


def test_artifacts_match_jax(runs):
    tf, jf = runs["torch"]["results_folder"], runs["jax"]["results_folder"]
    assert _files(tf) == _files(jf)
    assert "saved_models/model_last_epoch_checkpoint.pth.tar" in _files(tf)
    assert any(f.startswith("saved_models/model_val_acc_") for f in _files(tf))
    assert os.path.basename(tf) == "run" and tf.endswith(os.path.join("8_1_1", "run"))


def test_losses_and_accuracies_match_jax(runs):
    tf, jf = runs["torch"]["results_folder"], runs["jax"]["results_folder"]
    for name in ("train", "val"):
        ours, theirs = _npz(tf, name), _npz(jf, name)
        assert set(ours) == set(theirs)
        assert len(ours["loss"]) == (STEPS * EPOCHS if name == "train" else EPOCHS)
        np.testing.assert_allclose(ours["loss"], theirs["loss"], rtol=0, atol=LOSS_ATOL)
        np.testing.assert_array_equal(ours["balacc"], theirs["balacc"])
        assert np.isfinite(ours["loss"]).all()
    assert runs["torch"]["early_stopped"] == runs["jax"]["early_stopped"] is False


def test_hp_dict_matches_jax(runs):
    ours = _npz(runs["torch"]["results_folder"], "hp_dict")
    theirs = _npz(runs["jax"]["results_folder"], "hp_dict")
    assert set(ours) == set(theirs)
    for k in theirs:
        if k != "results_dir":
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert "['alpha']:(4,)" in ours["param_names_shapes"].tolist()


def test_log_lines_match_jax_up_to_their_numbers(runs):
    def masked(folder):
        with open(os.path.join(folder, "run.txt")) as f:
            return [re.sub(r"-?\d+(\.\d+)?(e[-+]?\d+)?", "#", line) for line in f]

    ours = masked(runs["torch"]["results_folder"])
    assert ours == masked(runs["jax"]["results_folder"])
    assert len(ours) == EPOCHS * (STEPS + 1) and ours[0].startswith("Epoch: [#][#/#]  lr: #")


def _adam(run):
    state = jckpt.load_checkpoint(os.path.join(run["results_folder"], ROLLING))
    return state["extra"]["opt_state"]["0"]


def test_weights_after_the_run_match_jax(runs):
    ours, theirs = to_jax_params(runs["torch"]["params"]), runs["jax"]["params"]
    tadam, jadam = _adam(runs["torch"]), _adam(runs["jax"])
    assert int(tadam["count"]) == int(jadam["count"]) == STEPS * EPOCHS
    init = jckpt.load_params(runs["init"])
    held = 0
    for k in theirs:
        want, got = np.asarray(theirs[k]), ours[k]
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * LR * STEPS * EPOCHS,
                                   err_msg=k)
        rms = np.sqrt(np.asarray(jadam["nu"][k]))
        if rms.max() == 0:  # a parameter the forward never reads
            np.testing.assert_array_equal(got, init[k], err_msg=k)
            np.testing.assert_array_equal(want, init[k], err_msg=k)
            continue
        clear = rms > CUT * rms.max()
        apart = clear & (np.abs(got - want) > 0.1 * LR)
        assert np.sum(apart) <= FLIPS, (k, np.sum(apart), np.sum(clear))
        held += int(np.sum(clear))
        for m in ("mu", "nu"):
            tm, jm = np.asarray(tadam[m][k]), np.asarray(jadam[m][k])
            gap = np.abs(tm - jm) / np.abs(jm).max()
            assert np.sum(gap > MOMENT_GAP) <= FLIPS, (k, m, np.sort(gap.ravel())[-3:])
            assert gap.mean() <= 0.1 * MOMENT_GAP, (k, m, gap.mean())
        # and the run moved the parameter by Adam's steps
        assert np.abs(want - init[k]).max() >= 0.5 * LR * STEPS * EPOCHS, k
    assert held > sum(np.size(v) for v in theirs.values()) // 2


def test_rolling_checkpoint_crosses_to_jax(runs):
    folder = runs["torch"]["results_folder"]
    rolling = os.path.join(folder, ROLLING)
    # The port's reader gives back the weights main returned, bit for bit.
    back = state_dict_from_jax("InT", tckpt.load_params(rolling))
    for k, v in runs["torch"]["params"].items():
        assert torch.equal(back[k], v), k
    # JAX reads the weights and its optimizer takes the state.
    params = jckpt.load_params(rolling, template=runs["template"])
    state = jckpt.load_checkpoint(rolling)
    assert int(state["epoch"]) == EPOCHS - 1
    opt = jmake_optimizer(LR)
    restored = serialization.from_state_dict(opt.init(params), state["extra"]["opt_state"])
    assert int(restored[0].count) == STEPS * EPOCHS
    # The best-val checkpoint, as eval picks it, loads in both packages.
    best = tckpt.find_best_checkpoint(folder)
    assert best == jckpt.find_best_checkpoint(folder) and "val_acc" in best
    model = tloop.init_model(_port_args(runs["argv"]), 8)
    tengine.load_ckpt(model, best)
    _assert_equal(to_jax_params(model.state_dict()),
                  jckpt.load_params(best, template=runs["template"]))


def _assert_equal(ours, theirs):
    assert set(ours) == set(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]), err_msg=k)


def test_port_resumes_the_jax_run_with_its_moments(runs, tmp_path, capsys, monkeypatch):
    """A copy of the JAX run's folder, relaunched by the port with
    --auto-resume and one more epoch: the rolling checkpoint's weights,
    epoch and Adam state continue, and the curves stay cumulative."""
    _same_order(monkeypatch)
    monkeypatch.setenv("PATHTRACKER_DATA_ROOT", str(runs["tmp"] / "data"))
    shutil.copytree(os.path.dirname(runs["jax"]["results_folder"]),
                    tmp_path / "8_1_1")
    capsys.readouterr()
    result = tloop.main(_port_args(
        ARGV + ["--epochs", str(EPOCHS + 1), "--auto-resume",
                "--results-dir", str(tmp_path)]),
        max_steps_per_epoch=STEPS)
    out = capsys.readouterr().out
    assert f"continuing from epoch {EPOCHS}" in out and "optimizer state restored" in out
    assert len(_npz(result["results_folder"], "val")["loss"]) == EPOCHS + 1
    assert len(_npz(result["results_folder"], "train")["loss"]) == STEPS * (EPOCHS + 1)
    state = tckpt.load_checkpoint(os.path.join(result["results_folder"], ROLLING))
    assert int(state["extra"]["opt_state"]["0"]["count"]) == STEPS * (EPOCHS + 1)


@pytest.fixture
def data_root(runs, monkeypatch):
    monkeypatch.setenv("PATHTRACKER_DATA_ROOT", str(runs["tmp"] / "data"))
    monkeypatch.setenv("PATHTRACKER_SYNTH_TRAIN", str(CLIPS))
    return runs["tmp"] / "data"


def _train(tmp_path, *extra, epochs=1):
    argv = ARGV + ["--epochs", str(epochs), "--results-dir", str(tmp_path), *extra]
    return tloop.main(_port_args(argv), max_steps_per_epoch=STEPS)


def test_auto_resume_continues_and_falls_back_on_other_flags(data_root, tmp_path, capsys):
    _train(tmp_path, "--auto-resume")
    folder = tmp_path / "8_1_1" / "run"
    assert "Epoch: [1]" not in (folder / "run.txt").read_text()
    capsys.readouterr()
    _train(tmp_path, "--auto-resume", epochs=2)
    out = capsys.readouterr().out
    assert "continuing from epoch 1" in out and "optimizer state restored" in out
    assert "Epoch: [1]" in (folder / "run.txt").read_text()
    assert len(_npz(str(folder), "val")["balacc"]) == 2
    assert len(_npz(str(folder), "train")["loss"]) == 2 * STEPS
    _train(tmp_path, "--auto-resume", "--ema", "0.9", epochs=3)
    assert "incompatible with the current flags" in capsys.readouterr().out


def test_sigterm_saves_the_rolling_checkpoint_and_exits_cleanly(data_root, tmp_path):
    code = (
        "import sys\n"
        "from pathtracker_torch.train import loop\n"
        "args = loop.parser.parse_args(sys.argv[1:])\n"
        "args.device = 'cpu'\n"
        "loop.main(args)\n")
    argv = ARGV + ["--epochs", "500", "--results-dir", str(tmp_path)]
    proc = subprocess.Popen([sys.executable, "-u", "-c", code, *argv], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, deadline = [], time.time() + 120
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("Epoch: [0]"):
            break
        assert time.time() < deadline, "".join(lines)
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=120)
    text = "".join(lines) + out
    assert proc.returncode == 0, text
    assert "terminated: logs + rolling checkpoint saved" in text, text
    folder = tmp_path / "8_1_1" / "run"
    assert (folder / "saved_models" / "model_last_epoch_checkpoint.pth.tar").exists()
    assert (folder / "train.npz").exists()


@pytest.mark.parametrize("flags,key,value", [
    (["--accum-steps", "2"], "accum_steps", 2),
    (["--ema", "0.5", "--lr", "1e-2"], "ema", "0.5"),
    (["--clip-grad", "1.0"], "clip_grad", "1.0"),
    (["--lr-schedule", "cosine"], "lr_schedule", "cosine"),
], ids=["accum", "ema", "clip", "cosine"])
def test_optimizer_flags_train_end_to_end(data_root, tmp_path, flags, key, value):
    result = _train(tmp_path, *flags)
    folder = result["results_folder"]
    assert {"train.npz", "val.npz", "hp_dict.npz", "run.txt"} <= set(_files(folder))
    assert str(_npz(folder, "hp_dict")[key]) == str(value)
    assert np.isfinite(_npz(folder, "train")["loss"]).all()
    rolling = tckpt.load_checkpoint(os.path.join(folder, ROLLING))
    best = [f for f in _files(folder) if "val_acc" in f]
    assert best
    if key == "ema":  # best-val checkpoints hold the EMA, the rolling one the raw weights
        ema = tckpt.load_checkpoint(os.path.join(folder, best[-1]))["state_dict"]
        assert max(float(np.abs(ema[k] - rolling["state_dict"][k]).max()) for k in ema) > 0
        assert set(rolling["extra"]["opt_state"]) == {"0", "1"}


def test_profile_writes_a_trace(data_root, tmp_path, capsys):
    _train(tmp_path / "r", "--profile", str(tmp_path / "trace"))
    assert "profiler trace written" in capsys.readouterr().out
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


@pytest.mark.parametrize("flags,env,item", [
    (["--device-data"], {}, None),
    (["--fused-steps", "2"], {}, None),
    ([], {"COORDINATOR_ADDRESS": "file"}, None),
    (["--parallel"], {"cards": 2}, "one process a card"),
], ids=["device-data", "fused-steps", "coordinator", "parallel-cards"])
def test_later_slice_flags_raise_naming_their_item(data_root, tmp_path, monkeypatch,
                                                   flags, env, item):
    """Item 9's flags (--device-data, and --fused-steps, which JAX ignores
    without it) train since the resident path landed; item 13's
    COORDINATOR_ADDRESS trains since its data-parallel half did (a world of
    one process here, its group left when main returns); --parallel over
    more cards than one, called in one process, raises before anything is
    written and names the launcher that starts a process a card."""
    from pathtracker_torch.parallel import distributed

    if env.pop("cards", None):
        monkeypatch.setattr(tloop, "resolve_device", lambda d: torch.device("cuda"))
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for k, v in env.items():
        monkeypatch.setenv(k, f"file://{tmp_path / 'rendezvous'}")
        monkeypatch.setenv("NUM_PROCESSES", "1")
    if item is None:
        result = _train(tmp_path, *flags)
        assert len(result["train_log"]["loss"]) == STEPS
        assert not distributed.is_initialized()
        return
    with pytest.raises(ValueError, match=item):
        _train(tmp_path, *flags)
    assert not (tmp_path / "8_1_1").exists()


def test_parallel_on_one_device_trains(data_root, tmp_path, capsys):
    result = _train(tmp_path, "--parallel")
    assert "Loading parallel finished on device count: 1" in capsys.readouterr().out
    assert np.isfinite(result["train_log"]["loss"]).all()


def test_cli_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CLI would train on it")
    out = subprocess.run(
        [sys.executable, "-m", "pathtracker_torch.train", *ARGV,
         "--results-dir", str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PATHTRACKER_DATA_ROOT": str(tmp_path / "d")})
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert not (tmp_path / "d").exists()


def test_rntsm_trains_with_remat_blocks_and_jax_reads_its_checkpoint(
        data_root, tmp_path, monkeypatch):
    """rntsm through main with --remat-blocks at a tiny trunk (one block a
    stage, basic blocks, patch 5), one capped epoch of 1 step; JAX reads its
    rolling checkpoint into an eval_shape template of the same trunk."""
    tiny = dict(layers=(1, 1, 1, 1), block="basic", patch=5)
    monkeypatch.setattr(TM, "resnet50_tsm", functools.partial(TM.TSMResNet, **tiny))
    args = _port_args(ARGV + ["--epochs", "1", "--remat-blocks", "--results-dir",
                              str(tmp_path), "-b", "2"], model="rntsm")
    result = tloop.main(args, max_steps_per_epoch=1)
    assert np.isfinite(result["train_log"]["loss"]).all()
    template = jax.eval_shape(
        lambda a: JM.TSMResNet(**tiny).init(jax.random.key(0), a),
        jax.ShapeDtypeStruct((1, 3, 2, 8, 8), np.float32))["params"]
    params = jckpt.load_params(os.path.join(result["results_folder"], ROLLING),
                               template=template)
    want = to_jax_params(result["params"])
    assert jax.tree.structure(params) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_pretrained_reads_a_local_file_only(tmp_path, monkeypatch):
    """--pretrained as the JAX package: a model without a torchvision
    counterpart warns and keeps its init; a video ResNet warns when no local
    file exists, and imports a local one (BN running statistics dropped,
    the Kinetics head skipped)."""
    monkeypatch.setenv("PATHTRACKER_PRETRAINED_DIR", str(tmp_path))
    args = _port_args(ARGV + ["--pretrained"])
    with pytest.warns(UserWarning, match="no torchvision checkpoint counterpart"):
        model = tloop.init_model(args, 8)
    fresh = tloop.init_model(_port_args(ARGV), 8)
    for k, v in fresh.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    with pytest.warns(UserWarning, match="no local torchvision checkpoint"):
        assert tloop.load_pretrained(fresh, "r3d") is fresh
    from pathtracker_torch.models import registry as TR

    r3d = TR.model_selector("r3d", timesteps=2, layers=(1, 1, 1, 1), device="cpu")
    head = r3d.fc.weight.detach().clone()
    trunk = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(i))
             for i, (k, v) in enumerate(r3d.state_dict().items()) if not k.startswith("fc.")}
    trunk["stem.1.running_mean"] = torch.zeros(64)
    trunk["fc.weight"], trunk["fc.bias"] = torch.ones(400, 512), torch.ones(400)
    torch.save(trunk, str(tmp_path / "r3d_18.pth"))
    assert tloop.load_pretrained(r3d, "r3d") is r3d
    assert torch.equal(r3d.stem[0].weight, trunk["stem.0.weight"])
    assert torch.equal(r3d.layer4[0].conv2[1].bias, trunk["layer4.0.conv2.1.bias"])
    assert torch.equal(r3d.fc.weight, head)
