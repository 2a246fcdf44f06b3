"""What both cells of the canonical chain share, held against the JAX
package at the chain's own sizes on the CPU: the epoch permutation the
resident windows draw from 20,000 clips, EarlyStopping and
find_best_checkpoint over the chains' real val curves (which stage-A
checkpoint B starts from), Adam over a 12-step window at InT's full width
(with C's EMA), and a resident window of the fused cell at full width
against JAX's resident window.

Tolerances. Integer draws and file choices exactly. Adam's weights and EMA
within rtol 1e-5 and 1e-3 of a step's size, its moments within rtol 1e-5
and 1e-6 of the moment's largest entry (f32 arithmetic in another order,
torch's lerp against optax's two products: entries that sums of gradients
of many magnitudes cancel to near zero differ by a few ulps of the
largest). The full-width window (bf16: the
plain versions of K1-K3 against JAX's eager mixed cell, two clips a step)
as tests/test_torch_chain.py holds the stages' steps: losses at rtol 1e-2,
the move of the weights from the start as one vector within 2% of JAX's in
length and at least 0.75 in cosine."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pathtracker_torch.data import prng
from pathtracker_torch.data import resident as TR
from pathtracker_torch.data.pathtracker import render_batch
from pathtracker_torch.models.int_circuit import InT
from pathtracker_torch.models.int_init import jax_int_params
from pathtracker_torch.train import checkpoint as tckpt
from pathtracker_torch.train import steps as TS
from pathtracker_torch.train.torch_import import (export_reference_state_dict,
                                                  state_dict_from_jax, to_jax_params)
from pathtracker_torch.utils.earlystopping import EarlyStopping as TEarlyStopping
from pathtracker_tpu.data import resident as JR
from pathtracker_tpu.models.int_circuit import InT as JInT
from pathtracker_tpu.train import checkpoint as jckpt
from pathtracker_tpu.train import steps as JS
from pathtracker_tpu.utils.earlystopping import EarlyStopping as JEarlyStopping
from torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN_CLIPS, CHAIN_BATCH, WINDOW = 20000, 128, 12  # the chain's knobs
STAGE_DIRS = {"A": "8_1_1", "B": "32_1_5", "C": "64_1_14"}
PATIENCE = 200  # train/loop.py's EarlyStopping


@pytest.mark.parametrize("epoch", [0, 1, 37, 59])
def test_epoch_permutation_at_the_chain_size(epoch):
    """The order a chain's stage draws its 20,000 clips in, every window of
    an epoch: the port's permutation is jax.random.permutation's."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(0), np.uint32(epoch)), 0)
    want = np.asarray(jax.random.permutation(key, CHAIN_CLIPS))
    got = prng.epoch_permutation(0, epoch, CHAIN_CLIPS, "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    steps = CHAIN_CLIPS // CHAIN_BATCH
    assert steps == 156 and steps % WINDOW == 0  # 13 whole windows, no ragged one


def _val_curves():
    """Every stage's val curve of the JAX package's chain and of the port's
    chains kept from the card: (label, folder, the checkpoint the next stage
    loaded or None)."""
    out = []
    roots = [("jax", ROOT, "")]
    kept = os.path.join(ROOT, "results_torch")
    for name in sorted(os.listdir(kept)) if os.path.isdir(kept) else ():
        if not name.startswith("chain_"):  # a crossover run, not a chain
            continue
        cell = name.split("_")[1]
        roots.append((name, os.path.join(kept, name), "" if cell == "fused" else f"{cell}_"))
    for label, root, pfx in roots:
        for tag, nxt in (("A", "B"), ("B", "C"), ("C", None)):
            folder = os.path.join(root, "results_conv", STAGE_DIRS[tag], f"{pfx}chain{tag}")
            loaded = None
            if nxt is not None:
                hp = np.load(os.path.join(root, "results_conv", STAGE_DIRS[nxt],
                                          f"{pfx}chain{nxt}", "hp_dict.npz"))
                loaded = os.path.basename(str(hp["loaded_ckpt"]))
            out.append((f"{label} {tag}", folder, loaded))
    return out


@pytest.mark.parametrize("label,folder,loaded", _val_curves(), ids=lambda v: str(v))
def test_best_checkpoint_over_the_chains_val_curves_is_jaxs(label, folder, loaded, tmp_path):
    """Each chain's val curve replayed through the port's and the JAX
    package's EarlyStopping (patience 200, as the loop sets it): the same
    checkpoints saved, and find_best_checkpoint of each package picks the
    same one, the one the chain's next stage loaded on the card."""
    balacc = np.load(os.path.join(folder, "val.npz"))["balacc"]
    state = InT(dimensions=8, timesteps=2, kernel_size=3, device="cpu").state_dict()
    picks = {}
    for name, cls, pick in (("torch", TEarlyStopping, tckpt.find_best_checkpoint),
                            ("jax", JEarlyStopping, jckpt.find_best_checkpoint)):
        run = tmp_path / name
        es = cls(patience=PATIENCE, results_folder=str(run), trace_func=lambda line: None)
        for epoch, acc in enumerate(balacc):
            es(float(acc), state if name == "torch" else to_jax_params(state), epoch)
        np.savez(run / "val.npz", balacc=balacc)
        picks[name] = (sorted(os.listdir(run / "saved_models")),
                       os.path.basename(pick(str(run))))
    assert picks["torch"] == picks["jax"], label
    if loaded is not None:
        assert picks["torch"][1] == loaded, label


def _full_width_params():
    model = InT(dimensions=32, timesteps=8, kernel_size=7, device="cpu")
    return [p for p in model.parameters() if p.requires_grad], model


@pytest.mark.parametrize("ema", [None, 0.998])
def test_adam_over_a_full_width_window_is_optax(ema):
    """Stage A's rate (stage C's, with its EMA) over a window of 12 steps
    of InT's full-width parameters, the scalars staged once for the window
    as the resident step stages them: parameters, Adam's moments and the
    EMA as optax's adam (and with_ema) leaves them."""
    lr = 2e-3 if ema is None else 1e-4
    params, model = _full_width_params()
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    jparams = to_jax_params(model.state_dict())
    tx = JS.make_optimizer(lr, ema=ema)
    state = tx.init(jparams)
    opt = TS.make_optimizer(lr, ema=ema)
    opt.init(params)
    opt.reserve(WINDOW)
    rng = np.random.default_rng(0)
    grads = []
    for i in range(WINDOW):
        scale = 10.0 ** rng.uniform(-4, 1)  # the chain's gradients span orders of magnitude
        g = {k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in jparams.items()}
        updates, state = tx.update(g, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        sd = state_dict_from_jax("InT", g)
        grads.append([sd[n] for n in names])
    opt.stage(WINDOW)
    for slot, g in enumerate(grads):
        opt.apply(g, slot)
    opt.advance(WINDOW)
    assert opt.count == WINDOW
    got = to_jax_params(model.state_dict())
    for k, want in jparams.items():
        np.testing.assert_allclose(got[k], np.asarray(want), rtol=1e-5, atol=1e-3 * lr,
                                   err_msg=k)
    inner = state[0] if ema is not None else state
    for moment, ours in (("mu", opt.mu), ("nu", opt.nu)):
        theirs = getattr(inner[0], moment)
        mine = to_jax_params(dict(zip(names, ours)))
        for k in theirs:
            want = np.asarray(theirs[k])
            np.testing.assert_allclose(mine[k], want, rtol=1e-5,
                                       atol=1e-6 * np.abs(want).max(), err_msg=f"{moment} {k}")
    if ema is not None:
        mine = to_jax_params(dict(zip(names, TS.ema_params(opt))))
        for k, want in JS.ema_params(state).items():
            np.testing.assert_allclose(mine[k], np.asarray(want), rtol=1e-5,
                                       atol=1e-3 * lr, err_msg=f"ema {k}")


W_CLIPS, W_BATCH, W_STEPS, W_T = 6, 2, 3, 8  # a window of 3 steps over 6 stage-A clips
COS_MIN, NORM_RTOL = 0.75, 0.02


def test_resident_window_at_full_width_is_jaxs():
    """Stage A's first window at the chain's width (dims 32, kernel 7,
    --bf16, lr 2e-3), from InT's seeded init (the JAX package's draw, as
    models/int_init.py makes it without JAX's init), through the
    port's resident window (the fused cell: K1-K3's plain versions here)
    and the JAX package's resident window (its eager mixed cell) on the
    same rendered clips: per-step losses and the move of the weights."""
    clips, labels = render_batch(3, W_CLIPS, timesteps=W_T, n_distractors=1, dot_size=2)
    labels = labels.astype(np.uint8)
    jm = JInT(dimensions=32, timesteps=W_T, kernel_size=7, dtype="bfloat16")
    init = jax_int_params(0, 32, 7, W_T)
    jopt = JS.make_optimizer(2e-3)
    jstep = JR.make_resident_train_step(jm, "InT", jopt, n_clips=W_CLIPS, batch_size=W_BATCH,
                                        seed=0, fused_steps=W_STEPS)
    jparams, jstate, jstats = jstep(jax.tree.map(jnp.asarray, init), jopt.init(init),
                                    jnp.asarray(clips), jnp.asarray(labels))
    model = InT(dimensions=32, timesteps=W_T, kernel_size=7, dtype="bfloat16", device="cpu")
    model.load_state_dict(export_reference_state_dict({k: np.asarray(v)
                                                       for k, v in init.items()}), strict=True)
    assert model.use_fused
    opt = TS.make_optimizer(2e-3)
    step = TR.make_resident_train_step(model, "InT", opt, n_clips=W_CLIPS, batch_size=W_BATCH,
                                       seed=0, fused_steps=W_STEPS)
    stats = step(torch.from_numpy(clips), torch.from_numpy(labels))
    np.testing.assert_allclose(np.atleast_1d(stats["loss"]), np.asarray(jstats["loss"]),
                               rtol=1e-2)
    start = {k: np.asarray(v) for k, v in init.items()}
    ours = to_jax_params(model.state_dict())
    moved = [np.concatenate([(np.asarray(tree[k]) - start[k]).ravel() for k in start])
             for tree in (ours, jparams)]
    cos = moved[0] @ moved[1] / np.linalg.norm(moved[0]) / np.linalg.norm(moved[1])
    ratio = np.linalg.norm(moved[0]) / np.linalg.norm(moved[1])
    assert cos >= COS_MIN and abs(ratio - 1.0) <= NORM_RTOL, (cos, ratio)
