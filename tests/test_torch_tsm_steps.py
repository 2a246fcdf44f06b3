"""A small ``rntsm`` (TSMResNet, layers (1,1,1,1), patch 5) through the
port's entry points against the JAX package's, on the same uint8 clips and
carried-across weights: a request through ``make_inference_fn``, one
``make_train_step`` update, an eval step, and the engine's dispatch.

Tolerances: scores and logits atol 1e-4 (f32 convs and batch statistics
summed in another order). The train step: packed stats 1e-3; Adam's first
update is lr*g/(|g|+eps), so every entry moves by at most lr and an entry
whose gradient the two packages agree on to a few percent (see
tests/test_torch_tsm_resnet.py on ReLU masks at rounding distance from zero)
lands within 0.1*lr; held: at most 2% of a parameter's entries past
0.1*lr, none past 2*lr.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracker_torch import engine as tengine
from pathtracker_torch.eval import serve as tserve
from pathtracker_torch.models import registry as tregistry
from pathtracker_torch.models import tsm_resnet as TM
from pathtracker_torch.train import steps as T
from pathtracker_torch.train.torch_import import (export_tsm_resnet_state_dict,
                                                  to_jax_params)
from pathtracker_tpu.eval import serve as jserve
from pathtracker_tpu.models import tsm_resnet as JM
from pathtracker_tpu.train import steps as J

B, TS, HW, PATCH, LR = 2, 4, 12, 5, 1e-3


def _small(seed=0, **tkwargs):
    rng = np.random.default_rng(seed)
    clips = rng.integers(0, 255, size=(2, B, TS, HW, HW, 3), dtype=np.uint8)
    labels = np.array([[0, 1], [1, 0]], dtype=np.uint8)
    jm = JM.TSMResNet(layers=(1, 1, 1, 1), patch=PATCH)
    params = jm.init(jax.random.key(0), jnp.zeros((B, 3, TS, HW, HW)))["params"]
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


@pytest.mark.parametrize("remat", [False, True])
def test_one_train_step_matches_jax(remat):
    jm, params, tm, clips, labels = _small(remat=remat)
    jstep = J.make_train_step(jm, "rntsm", J.make_optimizer(LR))
    jopt_state = J.make_optimizer(LR).init(params)
    start = jax.tree.map(np.asarray, params)
    jparams, _, jstats = jstep(jax.tree.map(jnp.copy, params), jopt_state,
                               jnp.asarray(clips[0]), jnp.asarray(labels[0]))
    tstats = T.make_train_step(tm.train(), "rntsm", T.make_optimizer(LR))(clips[0], labels[0])
    assert tuple(tstats) == T.TRAIN_KEYS == tuple(jstats)
    for key in T.TRAIN_KEYS:
        np.testing.assert_allclose(tstats[key], jstats[key], rtol=1e-3, atol=1e-3, err_msg=key)
    assert tstats["jvpen"] == 1.0  # the torchvision family's penalty is ones(1)
    ours = to_jax_params(tm.state_dict())
    moved = 0.0
    for path, want in jax.tree_util.tree_leaves_with_path(jparams):
        node, first = ours, start
        for part in path:
            node, first = node[part.key], first[part.key]
        want = np.asarray(want)
        diff = np.abs(node - want)
        name = jax.tree_util.keystr(path)
        assert diff.max() <= 2.0 * LR, (name, diff.max())
        assert np.mean(diff > 0.1 * LR) <= 0.02, (name, np.mean(diff > 0.1 * LR))
        moved = max(moved, np.abs(want - first).max())
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
    with pytest.raises(NotImplementedError, match="slowfast"):
        tengine.model_step(tm, x, "slowfast")


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
    for name in ("r3d", "mc3", "nostride_r3d", "slow", "slowfast_nl", "lambda"):
        with pytest.raises(NotImplementedError, match="later slice"):
            tregistry.model_selector(name, timesteps=2, device="cpu")
    with pytest.warns(UserWarning, match="pretrained"):
        tregistry.model_selector("rntsm", timesteps=2, pretrained=True, device="cpu")

