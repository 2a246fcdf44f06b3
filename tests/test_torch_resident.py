"""The port's device-resident data path (pathtracker_torch/data/resident.py,
data/prng.py) against the JAX package's (pathtracker_tpu/data/resident.py),
and --device-data / --fused-steps through the port's training loop, on the
CPU.

Tolerances. The epoch permutation and the validation batches exactly: both
are integer draws. A resident run against JAX's make_resident_train_step at
tests/test_train_e2e.py:131-211's sizes (12 clips, T=4, 16x16, dims 8, k 3,
batch 4, lr 1e-3, two epochs) by tests/test_torch_loop.py's rule: per-step
losses within 1e-3 (the f32 tolerance of tests/test_int_parity.py:93-129),
weights within 2*lr a step everywhere and within 0.1*lr of JAX's where the
RMS gradient (sqrt of JAX's Adam nu) clears CUT of its parameter's largest,
but for at most FLIPS entries a parameter (Adam's update is sign-like where a
gradient sits at rounding distance from zero)."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracker_torch.data import native as tnative
from pathtracker_torch.data import prng
from pathtracker_torch.data import resident as TR
from pathtracker_torch.data.pathtracker import make_synthetic_dataset
from pathtracker_torch.data.tfrecord import read_clip_records
from pathtracker_torch.models.int_circuit import InT as TInT
from pathtracker_torch.train import loop as tloop
from pathtracker_torch.train import steps as TS
from pathtracker_torch.train.torch_import import (export_reference_state_dict,
                                                  to_jax_params)
from pathtracker_tpu.data import resident as JR
from pathtracker_tpu.models.int_circuit import InT as JInT
from pathtracker_tpu.train import steps as JS

LR, LOSS_ATOL, FLIPS, CUT = 1e-3, 1e-3, 2, 5e-2
N_CLIPS, BATCH, EPOCHS = 12, 4, 2


@pytest.mark.parametrize("n", [12, 360, 2000])
def test_epoch_permutation_is_jax_random_permutation(n):
    rounds = int(np.ceil(3 * np.log(n) / np.log(2.0 ** 32 - 1)))
    assert rounds == (2 if n == 2000 else 1)
    for epoch in range(3):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.key(0), np.uint32(epoch)), 0)
        want = np.asarray(jax.random.permutation(key, n))
        got = prng.epoch_permutation(0, epoch, n, "cpu")
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"epoch {epoch}")


def test_load_resident_keeps_no_views(tmp_path):
    """Two shards read through the native reader, whose next decode reuses
    the buffer a view would point into (the port's form of
    tests/test_tfrecord.py:357)."""
    assert tnative.available()  # g++ and zlib build the port's reader here
    root = make_synthetic_dataset(str(tmp_path), n_train=10, n_test=2, timesteps=3,
                                  n_distractors=2, shards=2, seed=4)
    clips, labels = TR.load_resident(os.path.join(root, "train-*"), timesteps=3,
                                     device="cpu")
    disk = [r for path in sorted(glob.glob(os.path.join(root, "train-*")))
            for r in read_clip_records(path, timesteps=3)]
    np.testing.assert_array_equal(clips.numpy(), np.stack([c for c, _ in disk]))
    np.testing.assert_array_equal(labels.numpy(), np.asarray([lb for _, lb in disk], np.uint8))
    limited = TR.load_resident(os.path.join(root, "train-*"), timesteps=3, limit=7,
                               device="cpu")[0]
    np.testing.assert_array_equal(limited.numpy(), clips[:7].numpy())


def test_resident_batches_are_byte_equal_to_jax():
    rng = np.random.default_rng(3)
    clips = rng.integers(0, 255, size=(11, 2, 4, 4, 3), dtype=np.uint8)
    labels = rng.integers(0, 2, size=(11,), dtype=np.uint8)
    for shuffle in (True, False):
        ours = TR.ResidentBatches(torch.from_numpy(clips), torch.from_numpy(labels), 3,
                                  shuffle=shuffle, seed=5)
        theirs = JR.ResidentBatches(jnp.asarray(clips), jnp.asarray(labels), 3,
                                    shuffle=shuffle, seed=5)
        for _ in range(2):  # reshuffled on every pass
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) == 3
            for (c, lb), (jc, jl) in zip(got, want):
                np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
                np.testing.assert_array_equal(lb.numpy(), np.asarray(jl))


@pytest.fixture(scope="module")
def jax_run():
    """JAX's resident run, windows of 2 + 1 steps an epoch, from a seeded
    init; its per-step losses, final weights and Adam state."""
    rng = np.random.default_rng(1)
    clips = rng.integers(0, 255, size=(N_CLIPS, 4, 16, 16, 3), dtype=np.uint8)
    labels = rng.integers(0, 2, size=(N_CLIPS,), dtype=np.uint8)
    model = JInT(dimensions=8, timesteps=4, kernel_size=3)
    params0 = model.init(jax.random.key(0), jnp.zeros((BATCH, 3, 4, 16, 16)))["params"]
    opt = JS.make_optimizer(LR)
    step = JR.make_resident_train_step(model, "InT", opt, n_clips=N_CLIPS,
                                       batch_size=BATCH, seed=0, fused_steps=2)
    params, state = jax.tree.map(jnp.copy, params0), opt.init(params0)
    losses = []
    for _ in range(step.windows_per_epoch * EPOCHS):
        params, state, stats = step(params, state, jnp.asarray(clips), jnp.asarray(labels))
        losses.append(np.atleast_1d(stats["loss"]))
    return dict(clips=clips, labels=labels, init={k: np.asarray(v) for k, v in params0.items()},
                losses=np.concatenate(losses), params={k: np.asarray(v) for k, v in params.items()},
                nu={k: np.asarray(v) for k, v in state[0].nu.items()})


@pytest.mark.parametrize("fused", [1, 2])
def test_resident_training_matches_jax(jax_run, fused):
    model = TInT(dimensions=8, timesteps=4, kernel_size=3, device="cpu")
    model.load_state_dict(export_reference_state_dict(jax_run["init"]), strict=True)
    opt = TS.make_optimizer(LR)
    step = TR.make_resident_train_step(model, "InT", opt, n_clips=N_CLIPS,
                                       batch_size=BATCH, seed=0, fused_steps=fused)
    assert (step.steps_per_epoch, step.fused_steps) == (3, fused)
    assert step.windows_per_epoch == (3 if fused == 1 else 2)
    clips, labels = torch.from_numpy(jax_run["clips"]), torch.from_numpy(jax_run["labels"])
    losses = []
    for _ in range(step.windows_per_epoch * EPOCHS):
        stats = step(clips, labels)
        assert set(stats) == set(TS.TRAIN_KEYS)
        assert np.ndim(stats["loss"]) == (0 if fused == 1 else 1)
        losses.append(np.atleast_1d(stats["loss"]))
    losses = np.concatenate(losses)
    assert len(losses) == 3 * EPOCHS and opt.count == 3 * EPOCHS
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=0, atol=LOSS_ATOL)
    ours, steps = to_jax_params(model.state_dict()), 3 * EPOCHS
    held = 0
    for k, want in jax_run["params"].items():
        got = ours[k]
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * LR * steps, err_msg=k)
        rms = np.sqrt(jax_run["nu"][k])
        if rms.max() == 0:  # a parameter the forward never reads
            np.testing.assert_array_equal(got, jax_run["init"][k], err_msg=k)
            continue
        clear = rms > CUT * rms.max()
        assert np.sum(clear & (np.abs(got - want) > 0.1 * LR)) <= FLIPS, k
        held += int(np.sum(clear))
        assert not np.array_equal(got, jax_run["init"][k]), k  # the run moved it
    assert held > sum(v.size for v in jax_run["params"].values()) // 2


def test_windows_gather_the_indices_jax_gathers(monkeypatch):
    """``indices(s)``, the rule the windows gather by, against JAX's
    _gather_local (resident.py:164-176): slot s % steps_per_epoch of
    jax.random.permutation(fold_in(fold_in(key(seed), epoch), 0), n), the
    batch tiling the permutation mod n (10 clips of batch 4 leave a
    remainder); and each window's steps gather just those clips."""
    n, b, seed = 10, 4, 3
    clips = torch.zeros((n, 2, 8, 8, 3), dtype=torch.uint8)
    clips[:, 0, 0, 0, 0] = torch.arange(n, dtype=torch.uint8)  # a clip's own index
    labels = torch.arange(n, dtype=torch.uint8) % 2
    gathered = []
    prepare = TR.prepare_batch

    def recording(raw_imgs, raw_labels, **kw):
        gathered.append(raw_imgs[:, 0, 0, 0, 0].long())
        return prepare(raw_imgs, raw_labels, **kw)

    monkeypatch.setattr(TR, "prepare_batch", recording)
    model = TInT(dimensions=4, timesteps=2, kernel_size=3, device="cpu")
    step = TR.make_resident_train_step(model, "InT", TS.make_optimizer(LR), n_clips=n,
                                       batch_size=b, seed=seed, fused_steps=2)
    for _ in range(2 * step.windows_per_epoch):
        step(clips, labels)
    assert len(gathered) == 2 * step.steps_per_epoch
    for s, got in enumerate(gathered):
        epoch, slot = divmod(s, step.steps_per_epoch)
        key = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), np.uint32(epoch)), 0)
        want = np.asarray(jax.random.permutation(key, n))[(slot * b + np.arange(b)) % n]
        np.testing.assert_array_equal(step.indices(s).numpy(), want, err_msg=f"step {s}")
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"step {s}")


ARGV = ["--model", "InT", "--name", "run", "--length", "8", "--speed", "1",
        "--dist", "1", "-b", "4", "-d", "4", "-k", "3", "--lr", "3e-4",
        "--print-freq", "1", "--epochs", "1", "--device-data"]


@pytest.fixture
def data_root(tmp_path, monkeypatch):
    monkeypatch.setenv("PATHTRACKER_DATA_ROOT", str(tmp_path / "data"))
    monkeypatch.setenv("PATHTRACKER_SYNTH_TRAIN", "12")
    monkeypatch.setenv("PATHTRACKER_SYNTH_TEST", "8")
    return tmp_path


def _args(*extra, **attrs):
    args = tloop.parser.parse_args([*ARGV, *extra])
    args.device = "cpu"
    for k, v in attrs.items():
        setattr(args, k, v)
    return args


@pytest.mark.parametrize("extra", [[], ["--accum-steps", "2", "--ema", "0.5",
                                        "--clip-grad", "1.0"]], ids=["adam", "accum-ema-clip"])
def test_main_caps_optimizer_steps_under_fused_windows(data_root, extra):
    """tests/test_train_e2e.py:456-479 in the port: the cap counts optimizer
    steps, so one window of 2 and no more; the rolling checkpoint's Adam
    count follows (a half accumulation window makes no Adam step)."""
    from pathtracker_torch.train import checkpoint as ckpt_lib

    result = tloop.main(_args("--fused-steps", "2", *extra,
                              results_dir=str(data_root / "r")), max_steps_per_epoch=2)
    folder = result["results_folder"]
    train = np.load(os.path.join(folder, "train.npz"))
    assert len(train["loss"]) == 2 and np.isfinite(train["loss"]).all()
    assert len(np.load(os.path.join(folder, "val.npz"))["loss"]) == 1
    rolling = ckpt_lib.load_checkpoint(os.path.join(
        folder, "saved_models", tloop.ROLLING))["extra"]["opt_state"]
    node = rolling["0"] if extra else rolling
    count = node["gradient_step"] if extra else node["0"]["count"]
    assert int(count) == (1 if extra else 2)


@pytest.mark.parametrize("env,cards", [({"COORDINATOR_ADDRESS": "file"}, 1),
                                       ({}, 2)], ids=["coordinator", "parallel-cards"])
def test_item_13_refusals_come_before_the_resident_load(data_root, monkeypatch, env, cards):
    """Under COORDINATOR_ADDRESS the process group is joined before the
    resident load, which then reads the split on the host to keep this
    rank's slice, and left when main ends, here by the load's failure;
    --parallel over two cards in one process is refused before it."""
    from pathtracker_torch.parallel import distributed

    if cards > 1:
        monkeypatch.setattr(tloop, "resolve_device", lambda d: torch.device("cuda"))
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    for k in env:
        monkeypatch.setenv(k, f"file://{data_root / 'rendezvous'}")

    def load(pattern, timesteps, device=None):
        assert distributed.world_size() == 1 and str(device) == "cpu"
        raise LookupError("loaded")

    monkeypatch.setattr(tloop, "load_resident", load)
    with pytest.raises(LookupError if env else ValueError,
                       match="loaded" if env else "one process a card"):
        tloop.main(_args("--parallel", results_dir=str(data_root / "r")))
    assert not distributed.is_initialized()
