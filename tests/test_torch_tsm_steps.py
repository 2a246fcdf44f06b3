"""A small ``rntsm`` (TSMResNet, layers (1,1,1,1), patch 5) through the
port's entry points against the JAX package's, on the same uint8 clips and
carried-across weights: a request through ``make_inference_fn``, one
``make_train_step`` update, an eval step, and the engine's dispatch.

Tolerances: scores and logits atol 1e-4 (f32 convs and batch statistics
summed in another order).

The train step holds three things. (1) Packed stats within 1e-3. (2) The
gradient of the step's loss (prep, forward, BCE) for the batch, ``jax.grad``
against the port's ``.backward()``, each parameter's normalised by its
largest entry, to tests/test_torch_tsm_resnet.py's whole-net tolerances:
every entry within 0.1, but for at most FLIPS entries a parameter, and each
mean gap within 2e-2. The exception is the ReLU masks at rounding distance
from zero (that file's docstring): measured, the largest gap is 0.119, in
one entry of ``layer3_0.conv1.kernel``, and it is the JAX package's f32
that is off there (0.119 from the port's float64 gradient, while the port's
f32 is 0.007 from it). (3) Adam's first update, lr*g/(|g|+eps) with bias
correction: every entry moves by at most lr up to float rounding, the step
moves the parameters, and, entry by entry, the two updates agree within
0.1*lr wherever the gradient stands clear of rounding, |g| > CUT times the
parameter's largest entry, but for at most FLIPS whole entries a
parameter. Below the cut the update turns rounding noise into O(lr): the
first step of the port and the JAX package parted by up to 2*lr in entries
at 7e-9 to 3.2e-3 of their parameter's largest gradient (one in the
16-entry ``flow_refinement.pw1.bn_scale``); above it, a flipped mask moves a
channel's gradient by percents, and the updates parted in 10 entries
(``layer4_0.conv1.kernel``) above 1e-2 of the largest, in one above 3e-2 and
none above 0.1.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracker_torch import engine as tengine
from pathtracker_torch.data.prepare import prepare_batch as tprepare
from pathtracker_torch.eval import serve as tserve
from pathtracker_torch.models import registry as tregistry
from pathtracker_torch.models import tsm_resnet as TM
from pathtracker_torch.train import steps as T
from pathtracker_torch.train.torch_import import (export_tsm_resnet_state_dict,
                                                  to_jax_params)
from pathtracker_torch.utils import metrics as tmetrics
from pathtracker_tpu import engine as jengine
from pathtracker_tpu.data.prepare import prepare_batch as jprepare
from pathtracker_tpu.eval import serve as jserve
from pathtracker_tpu.models import tsm_resnet as JM
from pathtracker_tpu.train import steps as J
from pathtracker_tpu.utils import metrics as jmetrics

B, TS, HW, PATCH, LR = 2, 4, 12, 5, 1e-3


@functools.lru_cache(maxsize=None)
def _jax_net():
    """The JAX net and its params from one jitted ``init``, shared by the
    tests (eager, the init dispatched op by op for ~20 s a call)."""
    jm = JM.TSMResNet(layers=(1, 1, 1, 1), patch=PATCH)
    return jm, jax.jit(jm.init)(jax.random.key(0), jnp.zeros((B, 3, TS, HW, HW)))["params"]


def _small(seed=0, **tkwargs):
    rng = np.random.default_rng(seed)
    clips = rng.integers(0, 255, size=(2, B, TS, HW, HW, 3), dtype=np.uint8)
    labels = np.array([[0, 1], [1, 0]], dtype=np.uint8)
    jm, params = _jax_net()
    tm = TM.TSMResNet(layers=(1, 1, 1, 1), patch=PATCH, device="cpu", **tkwargs)
    tm.load_state_dict(export_tsm_resnet_state_dict(params), strict=True)
    return jm, params, tm, clips, labels


def test_request_through_make_inference_fn_matches_jax():
    jm, params, tm, clips, _ = _small()
    tm.eval()
    for probs in (True, False):
        want = np.asarray(jserve.make_inference_fn(jm, "rntsm", params, probs=probs)(clips[0]))
        got = tserve.make_inference_fn(tm, "rntsm", probs=probs)(clips[0])
        assert got.shape == (B,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


FLIPS = 2  # whole entries a parameter that a flipped ReLU mask may move
CUT = 5e-2  # of a parameter's largest gradient: the update is held above it


def _leaf(tree, path):
    for part in path:
        tree = tree[part.key]
    return tree


def _jax_gradients(jm, params, clips, labels):
    """``jax.grad`` of the loss J.make_train_step differentiates."""
    def loss(p):
        imgs, target = jprepare(jnp.asarray(clips), jnp.asarray(labels))
        output, _ = jengine.model_step(jm, {"params": p}, imgs, "rntsm")
        return jmetrics.bce_with_logits(output, target)

    return jax.jit(jax.grad(loss))(params)


def _port_gradients(tm, clips, labels):
    """The same loss through the port, by ``.backward()``; the parameters'
    ``.grad`` are cleared again."""
    imgs, target = tprepare(torch.as_tensor(clips), torch.as_tensor(labels))
    output, _ = tengine.model_step(tm, imgs, "rntsm")
    tmetrics.bce_with_logits(output, target).backward()
    grads = {name: p.grad for name, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    return to_jax_params(grads)


@functools.lru_cache(maxsize=None)
def _jax_step():
    """The JAX side of test_one_train_step_matches_jax, shared by its two
    cases (the port's remat does not reach it): the gradient of the step's
    loss, and the params and stats after one J.make_train_step update."""
    jm, params, _, clips, labels = _small()
    jgrads = _jax_gradients(jm, params, clips[0], labels[0])
    jstep = J.make_train_step(jm, "rntsm", J.make_optimizer(LR))
    jopt_state = J.make_optimizer(LR).init(params)
    jparams, _, jstats = jstep(jax.tree.map(jnp.copy, params), jopt_state,
                               jnp.asarray(clips[0]), jnp.asarray(labels[0]))
    return jgrads, jparams, jstats


@pytest.mark.parametrize("remat", [False, True])
def test_one_train_step_matches_jax(remat):
    jm, params, tm, clips, labels = _small(remat=remat)
    tm.train()
    jgrads, jparams, jstats = _jax_step()
    tgrads = _port_gradients(tm, clips[0], labels[0])
    start = jax.tree.map(np.asarray, params)
    tstats = T.make_train_step(tm, "rntsm", T.make_optimizer(LR))(clips[0], labels[0])
    assert tuple(tstats) == T.TRAIN_KEYS == tuple(jstats)
    for key in T.TRAIN_KEYS:
        np.testing.assert_allclose(tstats[key], jstats[key], rtol=1e-3, atol=1e-3, err_msg=key)
    assert tstats["jvpen"] == 1.0  # the torchvision family's penalty is ones(1)
    ours = to_jax_params(tm.state_dict())
    moved = 0.0
    for path, want in jax.tree_util.tree_leaves_with_path(jparams):
        name = jax.tree_util.keystr(path)
        jg, tg = np.asarray(_leaf(jgrads, path)), _leaf(tgrads, path)
        scale = np.abs(jg).max()
        gap = np.abs(tg - jg) / scale
        assert np.sum(gap > 0.1) <= FLIPS, (name, np.sort(gap.ravel())[-FLIPS - 1:])
        assert gap.mean() <= 2e-2, (name, gap.mean())

        first = _leaf(start, path)
        dt, dj = _leaf(ours, path) - first, np.asarray(want) - first
        rounding = np.spacing(np.abs(first))
        for d in (dt, dj):
            assert np.all(np.abs(d) <= LR * (1 + 1e-5) + rounding), (name, np.abs(d).max())
        clear = np.abs(jg) > CUT * scale
        apart = clear & (np.abs(dt - dj) > 0.1 * LR)
        assert np.sum(apart) <= FLIPS, (name, np.sum(apart), np.sum(clear))
        moved = max(moved, np.abs(dt).max(), np.abs(dj).max())
    assert moved >= 0.5 * LR  # and the step did move the parameters


def test_eval_step_matches_jax():
    jm, params, tm, clips, labels = _small()
    jstats = J.make_eval_step(jm, "rntsm")(params, jnp.asarray(clips[1]), jnp.asarray(labels[1]))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tstats = T.make_eval_step(tm, "rntsm")(clips[1], labels[1])
    assert tuple(tstats) == T.EVAL_KEYS + ("output",) == tuple(jstats)
    for key in T.EVAL_KEYS:
        np.testing.assert_allclose(tstats[key], jstats[key], rtol=1e-3, atol=1e-3, err_msg=key)
    out = tstats["output"]
    assert out.shape == (B, 1) and not out.requires_grad
    np.testing.assert_allclose(out.numpy(), np.asarray(jstats["output"]), rtol=0, atol=1e-4)
    assert all(torch.equal(v, before[k]) for k, v in tm.state_dict().items())


def test_engine_dispatches_the_torchvision_family():
    _, _, tm, clips, _ = _small()
    x = torch.from_numpy(clips[0]).permute(0, 4, 1, 2, 3).float() / 255.0
    with torch.no_grad():
        out, penalty = tengine.model_step(tm, x, "rntsm")
        again, states, gates = tengine.model_step(tm, x, "rntsm", test=True)
    assert out.shape == (B, 1) and torch.equal(penalty, torch.ones(1))
    assert torch.equal(out, again) and states is None and gates is None
    sf = tregistry.model_selector("slowfast", timesteps=TS, width=8, stage_blocks=(1, 1),
                                  device="cpu")
    with torch.no_grad():
        out, penalty = tengine.model_step(sf, x, "slowfast")
        again = tengine.model_step(sf, x, "slowfast", test=True)
    assert out.shape == (B, 1) and torch.equal(penalty, torch.ones(1))
    assert torch.equal(out, again[0]) and again[1:] == (None, None)


def test_registry_and_selector_build_rntsm_only():
    assert tregistry.family("rntsm") == "torchvision"
    assert not tregistry.needs_coord_channels("rntsm")
    args = types.SimpleNamespace(model="rntsm", bf16=True, remat_blocks=True)
    m = tengine.model_selector(args, 8, device="cpu", fused=False)
    assert isinstance(m, TM.TSMResNet) and m.remat and not m.fused
    assert (m.layers, m.block, m.num_segments, m.flow_estimation, m.patch) == (
        (3, 4, 6, 3), "bottleneck", 8, True, 15)
    assert all(p.dtype == torch.float32 for p in m.parameters())  # --bf16 does not reach rntsm
    assert not tengine.model_selector(types.SimpleNamespace(model="rntsm"), 8,
                                      device="cpu").remat
    with pytest.raises(NotImplementedError, match="remat-blocks"):
        tengine.model_selector(types.SimpleNamespace(model="InT", remat_blocks=True), 2,
                               device="cpu")
    for name in ("r3d", "mc3", "nostride_r3d"):
        m = tregistry.model_selector(name, timesteps=2, layers=(1, 1, 1, 1), device="cpu")
        assert not isinstance(m, TM.TSMResNet) and tregistry.family(name) == "torchvision"
    for name in ("slow", "slowfast_nl", "lambda"):
        extra = dict(height=4, width=4) if name == "lambda" else dict(width=8,
                                                                      stage_blocks=(1, 1))
        m = tregistry.model_selector(name, timesteps=2, device="cpu", **extra)
        assert not isinstance(m, TM.TSMResNet)
    with pytest.warns(UserWarning, match="pretrained"):
        tregistry.model_selector("rntsm", timesteps=2, pretrained=True, device="cpu")

