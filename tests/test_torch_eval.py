"""The port's held-out eval against pathtracker_tpu's: evaluate_model end
to end on one tiny shard and one JAX-written checkpoint (acc held exactly,
loss to atol 1e-3: the 5-step f32 tolerance of tests/test_int_parity.py),
the plots' files, the checkpoint choice, the parser, main's dispatch, the
engine API the eval reaches, and the retry wrapper."""

import functools
import os
import shlex
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pathtracker_torch import engine as tengine
from pathtracker_torch.data import native as tnative
from pathtracker_torch.data import pipeline as tpipeline
from pathtracker_torch.data import registry as tregistry
from pathtracker_torch.eval import test_model as ttm
from pathtracker_torch.models.int_circuit import InT
from pathtracker_torch.train import checkpoint as tckpt
from pathtracker_torch.train.torch_import import to_jax_params
from pathtracker_torch.utils.opts import parser as tparser
from pathtracker_tpu import engine as jengine
from pathtracker_tpu.data import native as jnative
from pathtracker_tpu.data import pipeline as jpipeline
from pathtracker_tpu.eval import test_model as jtm
from pathtracker_tpu.train import checkpoint as jckpt
from pathtracker_tpu.train.loop import init_model
from pathtracker_tpu.utils.opts import parser as jparser

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_ATOL = 1e-3
T, DIMS, K, BATCH = 8, 8, 3, 4
# (dist, speed, length) -> test clips: two batches for the seeded case, one
# batch for the unseeded one, where BN's batch statistics do not depend on
# the order the loader draws.
CONFIGS = {"seeded": ((1, 1, T), 2 * BATCH), "one-batch": ((2, 1, T), BATCH)}


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The tiny configs rendered under one data root, and a checkpoint of the
    JAX package's seeded init written by its save_checkpoint."""
    tmp = tmp_path_factory.mktemp("eval")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PATHTRACKER_DATA_ROOT", str(tmp / "data"))
        for (dist, speed, length), n_test in CONFIGS.values():
            tregistry.dataset_selector(dist, speed, length, synth_train=BATCH,
                                       synth_test=n_test)
        args = SimpleNamespace(model="InT", batch_size=BATCH, dimensions=DIMS,
                               fb_kernel_size=K, pretrained=False, algo="bptt",
                               seed=0, bf16=False, ckpt=str(tmp / "init.pth.tar"))
        _, variables = init_model(args, T)
        jckpt.save_checkpoint(args.ckpt, variables["params"])
        yield tmp, args, variables["params"]


def _same_order(monkeypatch):
    """Both packages' loaders on one batch order: the native one where the
    port's library builds (the JAX binding pointed at it), else Python."""
    if tnative.available():
        monkeypatch.setattr(jnative, "_SO_PATHS", [str(tnative.library_path())])
        monkeypatch.setattr(jnative, "_TRIED", False)
        monkeypatch.setattr(jnative, "_LIB", None)
        assert jnative.available()
    else:
        monkeypatch.setattr(jnative, "available", lambda: False)


def _files(folder):
    return sorted(os.path.relpath(os.path.join(d, n), folder)
                  for d, _, names in os.walk(folder) for n in names)


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_evaluate_model_matches_jax(tiny_run, monkeypatch, case):
    """evaluate_model of both packages on the same shard and checkpoint:
    'seeded' with both loaders seeded alike (monkeypatched), 'one-batch'
    unpatched (unseeded loaders, the whole split one batch) with
    prep_gifs=2, which writes the same files in both packages."""
    tmp, args, _ = tiny_run
    monkeypatch.setenv("PATHTRACKER_DATA_ROOT", str(tmp / "data"))
    _same_order(monkeypatch)
    (dist, speed, length), n_test = CONFIGS[case]
    gifs = 0
    if case == "seeded":
        monkeypatch.setattr(ttm, "tfr_data_loader",
                            functools.partial(tpipeline.tfr_data_loader, seed=3))
        monkeypatch.setattr(jtm, "tfr_data_loader",
                            functools.partial(jpipeline.tfr_data_loader, seed=3))
    else:
        gifs = 2
    out = {}
    for name, module, extra in (("torch", ttm, {"device": "cpu"}), ("jax", jtm, {})):
        folder = str(tmp / case / name)
        out[name] = module.evaluate_model(
            folder, SimpleNamespace(**vars(args), **extra), prep_gifs=gifs,
            dist=dist, speed=speed, length=length)
        saved = np.load(os.path.join(
            folder, f"test_perf_dist_{dist}_speed_{speed}_length_{length}.npz"))
        assert saved.files == ["arr_0", "arr_1"]
        assert (float(saved["arr_0"]), float(saved["arr_1"])) == out[name]
    (acc, loss), (jacc, jloss) = out["torch"], out["jax"]
    assert acc == jacc
    assert abs(loss - jloss) <= LOSS_ATOL, (loss, jloss)
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
    if gifs:
        files = _files(str(tmp / case / "torch"))
        assert files == _files(str(tmp / case / "jax"))
        assert sum(f.endswith(".gif") for f in files) == gifs


def test_evaluate_model_keeps_the_fused_dispatch_in_testmode(tiny_run, monkeypatch):
    """--bf16 at 32 channels dispatches to the fused cell, test=True too
    (here through the kernels' plain versions), one fused step a frame;
    states [B,T,1,H,W] and gates [B,T,C,H,W] in f32."""
    from pathtracker_torch.models import int_circuit

    steps = []
    fused_step = int_circuit._int_cell_step_fused
    monkeypatch.setattr(int_circuit, "_int_cell_step_fused",
                        lambda *a: steps.append(1) or fused_step(*a))
    model = tengine.model_selector(SimpleNamespace(model="InT", bf16=True), 2,
                                   device="cpu")
    assert model.use_fused
    clips = np.zeros((2, 2, 32, 32, 3), np.uint8)
    with torch.inference_mode():
        output, states, gates, loss, acc, imgs, target = ttm.eval_batch(
            model, "InT", clips, np.array([1, 0], np.uint8))
    assert len(steps) == 2  # one fused cell step per frame
    assert output.shape == (2, 1) and states.shape == (2, 2, 1, 32, 32)
    assert gates.shape == (2, 2, 32, 32, 32) and gates.dtype == torch.float32
    assert imgs.shape == (2, 3, 2, 32, 32) and float(acc) in (0.0, 0.5, 1.0)


def test_evaluate_model_skips_the_plots_without_matplotlib(tiny_run, monkeypatch):
    """On a machine without matplotlib or imageio the npz is written and the
    plots are skipped with a warning."""
    import importlib.util

    tmp, args, _ = tiny_run
    monkeypatch.setenv("PATHTRACKER_DATA_ROOT", str(tmp / "data"))
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "imageio" else find_spec(name, *a))
    (dist, speed, length), _ = CONFIGS["one-batch"]
    folder = tmp / "no-plots"
    with pytest.warns(UserWarning, match="plots and GIFs are skipped"):
        ttm.evaluate_model(str(folder), SimpleNamespace(**vars(args), device="cpu"),
                           prep_gifs=2, dist=dist, speed=speed, length=length)
    assert _files(str(folder)) == [f"test_perf_dist_{dist}_speed_{speed}_length_{length}.npz"]


def test_main_dispatches_as_jax(tiny_run, monkeypatch):
    """main without --ckpt finds the run folder and its best checkpoint and
    sweeps the configs of --which_tests; with --ckpt it evaluates one config
    into results/<name>. evaluate_model itself is recorded, not run."""
    tmp, _, _ = tiny_run
    run = tmp / "runs" / "64_1_14" / "r"
    (run / "saved_models").mkdir(parents=True)
    np.savez(run / "val.npz", balacc=np.array([50.0, 70.0, 60.0]))
    for i in range(3):
        path = run / "saved_models" / f"model_val_acc_00{60 + i}_epoch_0{i}_checkpoint.pth.tar"
        path.write_bytes(b"")
        os.utime(path, (1e9 + i, 1e9 + i))
    calls = {}
    for name, module in (("torch", ttm), ("jax", jtm)):
        seen = calls[name] = []

        def record(folder, args, prep_gifs=3, dist=14, speed=1, length=64, seen=seen):
            seen.append((folder, args.ckpt, args.batch_size, prep_gifs, dist, speed, length))
            return 0.5, 0.7

        monkeypatch.setattr(module, "evaluate_model", record)
        for argv in (["--model", "InT", "--name", "r", "--length", "64", "--speed",
                      "1", "--dist", "14", "--which_tests=64", "--results-dir",
                      str(tmp / "runs")],
                     ["--name", "r", "--ckpt", "x.tar", "--dist", "5", "-b", "7"]):
            module.main(module.parser.parse_args(argv))
    assert calls["torch"] == calls["jax"]
    assert len(calls["torch"]) == 7 and calls["torch"][0][1].endswith("epoch_01_checkpoint.pth.tar")


@pytest.mark.parametrize("balacc", [[50.0, 70.0, 60.0], [10.0, 20.0, 30.0, 40.0, 90.0]],
                         ids=["argmax", "clamped"])
def test_find_best_checkpoint_matches_jax(tmp_path, balacc):
    saved = tmp_path / "saved_models"
    saved.mkdir()
    np.savez(tmp_path / "val.npz", balacc=np.array(balacc))
    # Names sort unlike mtimes; the rolling snapshot is the newest file.
    names = ["model_val_acc_0070_epoch_01", "model_val_acc_0050_epoch_00",
             "model_val_acc_0090_epoch_04", "model_last_epoch"]
    for i, name in enumerate(names):
        path = saved / f"{name}_checkpoint.pth.tar"
        path.write_bytes(b"")
        os.utime(path, (1e9 + i, 1e9 + i))
    best = tckpt.find_best_checkpoint(str(tmp_path))
    assert best == jckpt.find_best_checkpoint(str(tmp_path))
    want = names[1] if balacc[1] == max(balacc) else names[2]
    assert os.path.basename(best) == f"{want}_checkpoint.pth.tar"
    for path in saved.iterdir():
        path.unlink()
    with pytest.raises(FileNotFoundError):
        tckpt.find_best_checkpoint(str(tmp_path))


def _launcher_argv(script):
    with open(os.path.join(ROOT, script)) as f:
        words = shlex.split(f.read().replace("\\\n", " "), comments=True)
    return words[words.index("python") + 2:]


@pytest.mark.parametrize("script", ["train_InT.sh", "test_InT.sh", None])
def test_parser_matches_jax(script):
    argv = _launcher_argv(script) if script else []
    assert vars(tparser.parse_args(argv)) == vars(jparser.parse_args(argv))
    assert len(tparser._actions) == len(jparser._actions) == 41  # 40 flags and -h


def test_engine_api_matches_jax(tiny_run):
    _, args, params = tiny_run
    assert tengine.get_datasets() == jengine.get_datasets()
    for name in ("InT_run2", "InT_no_inh_x", "rntsm", "nostride_r3d_cc_1", "hgru_v2b",
                 "slowfast_nl", "unknown"):
        assert tengine.fix_model_name(name) == jengine.fix_model_name(name)
    imgs = np.random.default_rng(0).random((2, 3, 9, 4, 4), dtype=np.float32)
    for got, want in zip(tengine.slowfast_pathways(torch.from_numpy(imgs)),
                         jengine.slowfast_pathways(imgs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    clips = np.random.default_rng(1).integers(0, 256, (2, 3, 32, 32, 3), dtype=np.uint8)
    labels = np.array([1, 0], np.uint8)
    for pretrained in (False, True):
        a = SimpleNamespace(model="InT", pretrained=pretrained)
        got = tengine.prepare_data(clips, labels, a, device="cpu")
        want = jengine.prepare_data(clips, labels, a)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_load_ckpt_strict_and_not(tiny_run, tmp_path):
    """strict=False keeps the model's own values where the checkpoint lacks a
    parameter, as the JAX package's merge with its template does."""
    _, args, params = tiny_run
    partial = {k: v for k, v in params.items() if k not in ("w", "mu")}
    path = str(tmp_path / "partial.tar")
    jckpt.save_checkpoint(path, partial)
    model = InT(dimensions=DIMS, timesteps=T, kernel_size=K, seed=1, device="cpu")
    with pytest.raises(RuntimeError, match="Missing key"):
        tengine.load_ckpt(model, path)
    before = to_jax_params(model.state_dict())
    tengine.load_ckpt(model, path, strict=False)
    got = to_jax_params(model.state_dict())
    want = jckpt.load_params(path, template={**params, **{k: before[k] for k in ("w", "mu")}},
                             strict=False)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


class _FakeXlaError(RuntimeError):
    pass


def test_transient_classification():
    assert ttm._is_transient_backend_error(
        _FakeXlaError("FAILED_PRECONDITION: device pool grant is stale"))
    assert ttm._is_transient_backend_error(
        _FakeXlaError("DEADLINE_EXCEEDED: tunnel RPC timed out"))
    assert ttm._is_transient_backend_error(_FakeXlaError("UNAVAILABLE: socket"))
    assert not ttm._is_transient_backend_error(ValueError("bad shape (2, 3)"))
    assert not ttm._is_transient_backend_error(
        _FakeXlaError("INVALID_ARGUMENT: dot dimension mismatch"))


def test_retry_recovers_from_one_transient_failure(tmp_path):
    calls = []

    def flaky(results_folder, args, prep_gifs=3, dist=14, speed=1, length=64):
        calls.append((dist, speed, length))
        if len(calls) == 1:
            raise _FakeXlaError("FAILED_PRECONDITION: stale grant")
        return 0.68, 0.59

    out = ttm.evaluate_model_with_retry(
        str(tmp_path / "r"), args=None, dist=5, speed=2, length=32,
        backoff_s=0.0, _eval_fn=flaky)
    assert out == (0.68, 0.59)
    assert calls == [(5, 2, 32), (5, 2, 32)]


def test_retry_gives_up_after_budget_and_prunes_empty_dir(tmp_path):
    rf = tmp_path / "results" / "doomed"

    def always_fails(results_folder, args, **kw):
        os.makedirs(results_folder, exist_ok=True)
        raise _FakeXlaError("FAILED_PRECONDITION: still wedged")

    with pytest.raises(_FakeXlaError):
        ttm.evaluate_model_with_retry(str(rf), args=None, retries=1,
                                      backoff_s=0.0, _eval_fn=always_fails)
    assert not rf.exists()


def test_non_transient_error_propagates_immediately(tmp_path):
    calls = []

    def buggy(results_folder, args, **kw):
        calls.append(1)
        raise ValueError("genuine bug")

    with pytest.raises(ValueError):
        ttm.evaluate_model_with_retry(str(tmp_path / "r"), args=None,
                                      backoff_s=0.0, _eval_fn=buggy)
    assert len(calls) == 1


def test_prune_keeps_nonempty_dir(tmp_path):
    d = tmp_path / "keep"
    d.mkdir()
    (d / "test_perf_dist_14_speed_1_length_64.npz").write_bytes(b"x")
    ttm._prune_empty_results_dir(str(d))
    assert d.exists()
