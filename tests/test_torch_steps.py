"""pathtracker_torch.train.steps against pathtracker_tpu.train.steps (optax):
the schedules, the optimizer's transformations on toy gradients, and whole
train and eval steps of a tiny InT on the same uint8 batches and weights.

Tolerances: schedules rtol 1e-6 plus 1e-6 of the base rate (f32 optax against
Python floats: near the end of a cosine decay optax's 1 + cos(~pi) cancels in
f32); optimizer
updates rtol 1e-5 / atol 1e-9 (the same f32 arithmetic in another order).
Whole train steps: Adam's first update is lr*g/(|g|+eps), which amplifies any
relative difference in a small gradient entry up to a full step of lr; so the
first step's parameters compare at 0.05*lr per entry off those entries
(where |g| clears its f32 cross-framework noise by far they agree to
rounding), later ones at 2*lr (every entry moves at most ~lr a step), and
the packed stats, which do not depend on the update's exact size, at 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pathtracker_torch.models.int_circuit import InT as TInT
from pathtracker_torch.train import steps as T
from pathtracker_torch.train.torch_import import (export_reference_state_dict,
                                                  to_jax_params)
from pathtracker_tpu.models.int_circuit import InT as JInT
from pathtracker_tpu.train import steps as J
from torch_threads import one_thread  # noqa: F401


# --------------------------------- schedules ---------------------------------

@pytest.mark.parametrize("kwargs", [
    dict(kind="step", lr=1e-3, steps_per_epoch=7, epochs=6, lr_steps=[2, 4], gamma=0.1),
    dict(kind="step", lr=3e-4, steps_per_epoch=5, epochs=4, lr_steps=["1", "2.5"], gamma=0.5),
    dict(kind="cosine", lr=1e-3, steps_per_epoch=7, epochs=5),
    dict(kind="warmup_cosine", lr=1e-3, steps_per_epoch=7, epochs=5, warmup_epochs=1.5),
    dict(kind="warmup_cosine", lr=1e-3, steps_per_epoch=7, epochs=5, warmup_epochs=0.0),
    dict(kind="cosine", lr=1e-3, steps_per_epoch=7, epochs=5, start_step=11),
    dict(kind="step", lr=1e-3, steps_per_epoch=7, epochs=6, lr_steps=[2, 4], start_step=13),
])
def test_schedules_match_optax(kwargs):
    ours, theirs = T.build_lr_schedule(**kwargs), J.build_lr_schedule(**kwargs)
    total = kwargs["steps_per_epoch"] * kwargs["epochs"]
    for step in range(total + 10):  # past every boundary and the end
        np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-6,
                                   atol=1e-6 * kwargs["lr"], err_msg=f"step {step}")


def test_schedule_none_and_unknown():
    assert T.build_lr_schedule("none", 1e-3, 5, 5) is None
    assert T.build_lr_schedule("", 1e-3, 5, 5) is None
    with pytest.raises(ValueError, match="unknown lr schedule"):
        T.build_lr_schedule("linear", 1e-3, 5, 5)


# --------------------------------- optimizer ---------------------------------

def _run_both(kwargs, grads_seq, params0):
    """Apply the same gradient sequence with both optimizers; returns the
    parameter trajectories and the final EMA trees (or None)."""
    jopt = J.make_optimizer(**kwargs)
    jparams = {k: jnp.asarray(v) for k, v in params0.items()}
    jstate = jopt.init(jparams)
    topt = T.make_optimizer(**kwargs)
    tparams = {k: torch.tensor(v) for k, v in params0.items()}
    topt.init(tparams)
    traj = []
    for grads in grads_seq:
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()},
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        topt.step([torch.tensor(grads[k]) for k in tparams])
        traj.append(({k: v.numpy().copy() for k, v in tparams.items()},
                     {k: np.asarray(v) for k, v in jparams.items()}))
    ema = None
    if kwargs.get("ema") is not None:
        ema = (dict(zip(tparams, (e.numpy() for e in T.ema_params(topt)))),
               {k: np.asarray(v) for k, v in J.ema_params(jstate).items()})
    return traj, ema


def _toy(seed=0, steps=7):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 10 ** rng.uniform(-3, 1)).astype(np.float32)
              for k, v in params.items()} for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("kwargs", [
    dict(lr=1e-3),
    dict(lr=1e-3, clip_grad=0.5),
    dict(lr=1e-3, clip_grad=100.0),
    dict(lr=1e-3, accum_steps=2),
    dict(lr=1e-3, accum_steps=3, clip_grad=0.5),
    dict(lr=1e-3, ema=0.9),
    dict(lr=1e-3, ema=0.9, accum_steps=2),
    dict(lr=1e-3, ema=0.99, accum_steps=2, clip_grad=0.5),
    dict(lr=1e-3, lr_steps=[2, 4], gamma=0.1),
    dict(lr=1e-3, lr_steps=[1, 2], gamma=0.5, accum_steps=2),
], ids=str)
def test_optimizer_matches_optax(kwargs):
    params, grads = _toy()
    traj, ema = _run_both(kwargs, grads, params)
    for i, (ours, theirs) in enumerate(traj):
        for k in ours:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5, atol=1e-9,
                                       err_msg=f"step {i} {k}")
    if ema is not None:
        for k in ema[0]:
            np.testing.assert_allclose(ema[0][k], ema[1][k], rtol=1e-5, atol=1e-9)


def test_schedule_object_takes_precedence_and_indexes_optimizer_steps():
    """A prebuilt schedule wins over lr/lr_steps; under accumulation it is
    read once per optimizer step, step 0 reading schedule(0)."""
    seen = []

    def schedule(step):
        seen.append(step)
        return 1e-2 / (step + 1)

    params, grads = _toy(steps=6)
    opt = T.make_optimizer(5.0, lr_steps=[1], schedule=schedule, accum_steps=2)
    tparams = [torch.tensor(v) for v in params.values()]
    opt.init(tparams)
    for g in grads:
        opt.step([torch.tensor(v) for v in g.values()])
    assert seen == [0, 1, 2] and opt.count == 3


def test_clip_is_optax_form_without_epsilon():
    """g * clip / max(norm, clip): a gradient of norm exactly 5 clipped to 0.5
    is scaled by 0.1 exactly (torch's clip_grad_norm_ divides by norm + 1e-6)."""
    params = {"w": np.zeros(4, np.float32)}
    grads = {"w": np.array([3.0, -4.0, 0.0, 0.0], np.float32)}
    clipped, _ = _run_both(dict(lr=1e-3, clip_grad=0.5), [grads], params)
    scaled, _ = _run_both(dict(lr=1e-3), [{"w": grads["w"] * np.float32(0.1)}], params)
    np.testing.assert_allclose(clipped[0][0]["w"], scaled[0][0]["w"], rtol=1e-5)
    np.testing.assert_allclose(clipped[0][0]["w"], clipped[0][1]["w"], rtol=1e-5)


def test_accumulation_emits_nothing_mid_window_but_ema_moves():
    params, grads = _toy(steps=2)
    opt = T.make_optimizer(1e-3, accum_steps=2, ema=0.5)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    opt.init(tparams)
    ema0 = [e.clone() for e in T.ema_params(opt)]
    opt.step([torch.tensor(grads[0][k]) for k in tparams])
    for k in tparams:  # mid-window: parameters untouched
        assert np.array_equal(tparams[k].numpy(), params[k])
    # the EMA of unchanged parameters stays where it is, but it did update
    for e, e0 in zip(T.ema_params(opt), ema0):
        torch.testing.assert_close(e, e0)
    opt.step([torch.tensor(grads[1][k]) for k in tparams])
    assert all(not np.array_equal(tparams[k].numpy(), params[k]) for k in tparams)
    for e, p, e0 in zip(T.ema_params(opt), tparams.values(), ema0):
        torch.testing.assert_close(e, 0.5 * e0 + 0.5 * p)


def test_parameter_without_gradient_stays():
    params = {"w": np.ones(3, np.float32), "unused": np.full(2, 7.0, np.float32)}
    opt = T.make_optimizer(1e-2).init({k: torch.tensor(v) for k, v in params.items()})
    for _ in range(3):
        opt.step([torch.ones(3), None])
    assert torch.equal(opt.params[1], torch.full((2,), 7.0))
    assert not torch.equal(opt.params[0], torch.ones(3))
    with pytest.raises(ValueError):
        opt.step([torch.ones(3)])  # one gradient per parameter
    with pytest.raises(ValueError, match="no EMA"):
        T.ema_params(opt)


# ------------------------------- whole steps ---------------------------------

B, C, TS, HW, K, LR = 4, 8, 4, 16, 3, 1e-3


def _tiny(case=None, opt_kwargs=None):
    rng = np.random.default_rng(0)
    clips = rng.integers(0, 255, size=(3, B, TS, HW, HW, 3), dtype=np.uint8)
    labels = rng.integers(0, 2, size=(3, B), dtype=np.uint8)
    jm = JInT(dimensions=C, timesteps=TS, kernel_size=K, **(case or {}))
    params = jm.init(jax.random.key(0), jnp.zeros((B, 3, TS, HW, HW)))["params"]
    tm = TInT(dimensions=C, timesteps=TS, kernel_size=K, device="cpu", **(case or {}))
    tm.load_state_dict(export_reference_state_dict(
        {n: np.asarray(v) for n, v in params.items()}), strict=True)
    return jm, params, tm, clips, labels


def test_first_step_gradients_and_stats_match_jax():
    """Before any update the two packages agree on the loss, the meters and
    every gradient (normalised, atol 1e-3 as tests/test_torch_int_grad.py)."""
    jm, params, tm, clips, labels = _tiny()

    def loss(p):
        imgs, target = J.prepare_batch(jnp.asarray(clips[0]), jnp.asarray(labels[0]))
        out, _ = J.model_step(jm, {"params": p}, imgs, "InT")
        return J.bce_with_logits(out, target)

    theirs = {n: np.asarray(g) for n, g in jax.grad(loss)(params).items()}
    imgs, target = T.prepare_batch(torch.from_numpy(clips[0]), torch.from_numpy(labels[0]))
    out, _ = T.model_step(tm, imgs, "InT")
    names, tensors = zip(*tm.named_parameters())
    grads = torch.autograd.grad(T.bce_with_logits(out, target), tensors, allow_unused=True)
    ours = to_jax_params({n: torch.zeros_like(p) if g is None else g
                          for n, p, g in zip(names, tensors, grads)})
    for n, want in theirs.items():
        scale = max(np.abs(want).max(), 1e-3)
        np.testing.assert_allclose(ours[n] / scale, want / scale, rtol=0, atol=1e-3,
                                   err_msg=n)


@pytest.mark.parametrize("penalty", [False, True])
def test_three_train_steps_match_jax(penalty):
    jm, params, tm, clips, labels = _tiny()
    jstep = J.make_train_step(jm, "InT", J.make_optimizer(LR), penalty=penalty)
    jopt_state = J.make_optimizer(LR).init(params)
    tstep = T.make_train_step(tm, "InT", T.make_optimizer(LR), penalty=penalty)
    unused = tm.unit1.w.detach().clone()
    jparams = jax.tree.map(jnp.copy, params)
    for i in range(3):
        jparams, jopt_state, jstats = jstep(jparams, jopt_state, jnp.asarray(clips[i]),
                                            jnp.asarray(labels[i]))
        tstats = tstep(clips[i], labels[i])  # numpy in: the step moves it over
        assert tuple(tstats) == T.TRAIN_KEYS == tuple(jstats)
        for key in T.TRAIN_KEYS:
            assert isinstance(tstats[key], np.float32)
            np.testing.assert_allclose(tstats[key], jstats[key], rtol=1e-3, atol=1e-3,
                                       err_msg=f"step {i} {key}")
        if penalty:  # jv_penalty is ones(1): the scaled loss carries 10 * 1
            np.testing.assert_allclose(tstats["scaled_loss"], tstats["loss"] + 10.0,
                                       rtol=1e-6)
        ours = to_jax_params(tm.state_dict())
        budget = (0.05 if i == 0 else 2.0) * LR
        moved = 0.0
        for n, want in jparams.items():
            diff = np.abs(ours[n] - np.asarray(want))
            moved = max(moved, np.abs(np.asarray(want) - np.asarray(params[n])).max())
            if i == 0:
                # all but a few entries (tiny gradients, sign-like update) agree
                assert np.mean(diff > budget) <= 0.02, (n, np.mean(diff > budget))
                assert diff.max() <= 2.0 * LR, (n, diff.max())
            else:
                assert diff.max() <= budget, (n, diff.max())
        assert moved >= 0.5 * LR  # and the step did move the parameters
    assert torch.equal(tm.unit1.w, unused)


def test_train_step_runs_the_mixed_fused_cell_and_accumulates():
    """make_train_step over the fused cell (plain kernel versions on the CPU)
    with accumulation: the parameters move on every second call only."""
    tm = TInT(dimensions=32, timesteps=3, kernel_size=3, dtype="bfloat16", device="cpu")
    assert tm.use_fused
    rng = np.random.default_rng(1)
    clips = rng.integers(0, 255, size=(B, 3, HW, HW, 3), dtype=np.uint8)
    labels = rng.integers(0, 2, size=(B,), dtype=np.uint8)
    opt = T.make_optimizer(LR, accum_steps=2, clip_grad=1.0, ema=0.9)
    step = T.make_train_step(tm, "InT", opt)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    stats = step(clips, labels)
    assert all(np.isfinite(v) for v in stats.values())
    assert all(torch.equal(v, before[k]) for k, v in tm.state_dict().items())
    step(clips, labels)
    assert not torch.equal(tm.unit1.w_exc, before["unit1.w_exc"])
    assert opt.count == 1 and len(T.ema_params(opt)) == len(opt.params)


def test_eval_step_matches_jax():
    jm, params, tm, clips, labels = _tiny()
    jstats = J.make_eval_step(jm, "InT")(params, jnp.asarray(clips[1]), jnp.asarray(labels[1]))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tstats = T.make_eval_step(tm, "InT")(clips[1], labels[1])
    assert tuple(tstats) == T.EVAL_KEYS + ("output",) == tuple(jstats)
    for key in T.EVAL_KEYS:
        np.testing.assert_allclose(tstats[key], jstats[key], rtol=1e-3, atol=1e-3, err_msg=key)
    out = tstats["output"]
    assert isinstance(out, torch.Tensor) and not out.requires_grad
    np.testing.assert_allclose(out.numpy(), np.asarray(jstats["output"]), rtol=1e-3, atol=1e-3)
    assert all(torch.equal(v, before[k]) for k, v in tm.state_dict().items())
