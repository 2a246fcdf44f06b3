"""The training CLI over two processes (tests/test_multihost.py:148-200 in
the port): each process runs ``python -m pathtracker_torch.train`` with
COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID set (a file rendezvous
under the test's tmp folder, gloo, on the CPU by PATHTRACKER_TORCH_DEVICE),
reads its own shard of a synthetic root rendered here first, and only
rank 0 writes the run folder.

Rank logs go to files, not pipes: a rank blocked on a full pipe stalls its
peer inside a collective. Any rank alive at the timeout is killed.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from pathtracker_torch.data import registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--model", "InT", "--name", "mh", "--length", "8", "--speed", "1", "--dist", "5",
        "-b", "8", "-d", "8", "-k", "3", "--print-freq", "1", "--parallel"]
TIMEOUT = 240


def _root(tmp_path, monkeypatch, n_train: int, n_test: int = 32):
    """The synthetic root, rendered once here (the ranks would race)."""
    env = {"PATHTRACKER_DATA_ROOT": str(tmp_path / "data"),
           "PATHTRACKER_SYNTH_TRAIN": str(n_train), "PATHTRACKER_SYNTH_TEST": str(n_test)}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    registry.dataset_selector(dist=5, speed=1, length=8)
    return env


def _start(tmp_path, env, extra=()):
    procs, paths = [], []
    for rank in (0, 1):
        path = tmp_path / f"rank{rank}.out"
        paths.append(path)
        with open(path, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pathtracker_torch.train", *ARGV, *extra,
                 "--results-dir", str(tmp_path / f"results{rank}")],
                cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
                env={**os.environ, **env, "OMP_NUM_THREADS": "1",
                     "PATHTRACKER_TORCH_DEVICE": "cpu",
                     "COORDINATOR_ADDRESS": f"file://{tmp_path / 'rendezvous'}",
                     "NUM_PROCESSES": "2", "PROCESS_ID": str(rank)}))
    return procs, paths


def _finish(procs, paths, timeout=TIMEOUT):
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = [path.read_text() for path in paths]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{out[-4000:]}"
    return outs


def test_two_process_cli_writes_rank_0s_run_only(tmp_path, monkeypatch):
    """Rank 0 reads train-00000 (8 clips), rank 1 train-00001 (7): at 4 clips
    a rank a step, rank 1's shard ends after one step, and rank 0 stops
    there with it instead of waiting in a collective."""
    env = _root(tmp_path, monkeypatch, n_train=15)
    outs = _finish(*_start(tmp_path, env, ["--epochs", "1"]))
    for rank, out in enumerate(outs):
        assert f"input shard: rank {rank}/2 files=1 record_stride=None" in out, out
        assert "Loading parallel finished on device count: 2" in out, out
    run0 = tmp_path / "results0" / "8_1_5" / "mh"
    assert (run0 / "train.npz").exists() and (run0 / "val.npz").exists()
    assert list((run0 / "saved_models").glob("*.tar")), "no checkpoint saved"
    assert not (tmp_path / "results1").exists()
    train = np.load(run0 / "train.npz")
    assert len(train["loss"]) == 1 and np.isfinite(train["loss"]).all()
    # The global metrics, the same on both ranks: each step's log line and
    # the validation line.
    for prefix in ("Epoch: [0][0/", "val f"):
        lines = [[ln.split("  Time")[0] if prefix.startswith("Epoch") else ln
                  for ln in out.splitlines() if ln.startswith(prefix)] for out in outs]
        assert lines[0] and lines[0] == lines[1], lines
    loss = [[ln.split("Loss: ")[1].split()[0] for ln in out.splitlines()
             if ln.startswith("Epoch:")] for out in outs]
    assert loss[0] == loss[1] == [f"{train['loss'][0]:.8f}"]


def test_sigterm_on_one_rank_stops_both_at_the_same_step(tmp_path, monkeypatch):
    """A SIGTERM to rank 1 alone: both ranks leave the epoch before the same
    step, write their logs and rolling checkpoint (rank 0's the real one) and
    exit cleanly."""
    env = _root(tmp_path, monkeypatch, n_train=64, n_test=16)
    procs, paths = _start(tmp_path, env, ["--epochs", "50"])
    deadline = time.time() + TIMEOUT
    while "Epoch: [0][1/" not in paths[1].read_text():
        if time.time() > deadline or any(p.poll() is not None for p in procs):
            _finish(procs, paths, timeout=1)
            pytest.fail("rank 1 never reached its second step")
        time.sleep(0.2)
    procs[1].send_signal(signal.SIGTERM)
    outs = _finish(procs, paths)
    for out in outs:
        assert "terminated: logs + rolling checkpoint saved mid-epoch 0" in out, out[-2000:]
    steps = [sum(ln.startswith("Epoch:") for ln in out.splitlines()) for out in outs]
    assert steps[0] == steps[1] >= 2, steps
    run0 = tmp_path / "results0" / "8_1_5" / "mh"
    assert (run0 / "saved_models" / "model_last_epoch_checkpoint.pth.tar").exists()
    assert len(np.load(run0 / "train.npz")["loss"]) == steps[0]


def test_launch_starts_a_process_a_card_on_one_host(tmp_path, monkeypatch, capfd):
    """``loop.launch``, what ``python -m pathtracker_torch.train --parallel``
    runs on a host of k > 1 cards: k processes on a file rendezvous of their
    own, here two on the CPU; rank 0 writes the run folder."""
    from pathtracker_torch.train import loop

    _root(tmp_path, monkeypatch, n_train=16, n_test=16)
    args = loop.parser.parse_args([*ARGV, "--epochs", "1", "--results-dir",
                                   str(tmp_path / "results")])
    args.device = "cpu"
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    loop.launch(args, 2)
    out = capfd.readouterr().out
    assert out.count("Loading parallel finished on device count: 2") == 2, out
    assert "input shard: rank 1/2" in out
    run = tmp_path / "results" / "8_1_5" / "mh"
    assert len(np.load(run / "train.npz")["loss"]) == 2  # 8 clips a rank, 4 a step


@pytest.mark.parametrize("flags,device,match", [
    (["--algo", "rbp"], "cpu", "rbp does not train data-parallel"),
    (["--device-data"], "cuda", "cannot hold gloo's collectives"),
], ids=["rbp", "gloo-windows"])
def test_a_data_group_refuses_what_it_cannot_run(monkeypatch, flags, device, match):
    """Under a data group: RBP's Neumann exit test reads one rank's norm,
    so ranks would take different numbers of terms; resident windows on
    the card are CUDA graphs, which gloo's collectives cannot enter. Both
    raise before anything loads."""
    import torch

    from pathtracker_torch.train import loop

    monkeypatch.setattr(torch.distributed, "get_backend", lambda group=None: "gloo")
    args = loop.parser.parse_args([*ARGV, *flags])
    with pytest.raises(ValueError, match=match):
        loop._refuse_later_slices(args, torch.device(device), mesh=object())
    loop._refuse_later_slices(args, torch.device(device), mesh=None)
