"""The port's transformer baselines (``timesformer``, ``performer``,
``lambda``), its ViT support module and ops/favor.py against
pathtracker_tpu's, on the same seeded inputs and the same weights, at
T=4, 8x8 clips (the TimeSformer at patch 4, the lambda layer at 8
channels a frame); checkpoints both ways, one performer train step with
its optimizer state, and the train and eval CLIs.

The weights are the port's seeded init carried to JAX (``to_jax_params``),
every 1-D leaf (LayerNorm and BN affines, biases) moved off its constant
init; each JAX model runs once under one ``jax.jit`` (cached, shared by
every test of that model).

Tolerances:
  * ``causal_linear_attention``: values and gradients atol 1e-5 / rtol
    1e-4 (f32 sums of a few dozen positive products, in another order);
  * f32 logits: atol 1e-3 / rtol 5e-3, the JAX package's bound for its InT
    against the reference over 5 steps (tests/test_int_parity.py:93);
  * gradients of sum(logit^2) for every parameter, each normalised by its
    largest entry (floored at 1e-3 of the model's largest), atol 1e-3, as
    tests/test_torch_zoo.py; these nets are smooth (GELU, softmax,
    softplus), so f32 holds;
  * the train step: packed stats within 1e-3 and Adam's first update
    entry by entry within 0.1*lr where the gradient stands clear of
    rounding (above 1e-3 of its parameter's largest entry); ``favor_proj``
    bit-unchanged, its moments zero, in both packages;
  * checkpoints and the optimizer state's layout: exact.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax import serialization

from pathtracker_torch import engine as tengine
from pathtracker_torch.data.prepare import prepare_batch as tprepare
from pathtracker_torch.models import registry as TR
from pathtracker_torch.models import vit as PV
from pathtracker_torch.ops import favor as PF
from pathtracker_torch.ops import initializers as PI
from pathtracker_torch.train import checkpoint as tckpt
from pathtracker_torch.train import loop as tloop
from pathtracker_torch.train import steps as T
from pathtracker_torch.train.torch_import import state_dict_from_jax, to_jax_params
from pathtracker_torch.utils import metrics as tmetrics
from pathtracker_tpu.models import registry as JR
from pathtracker_tpu.models import vit as JV
from pathtracker_tpu.ops import favor as JF
from pathtracker_tpu.train import checkpoint as jckpt
from pathtracker_tpu.train import steps as J
from torch_threads import one_thread  # noqa: F401

B, TS, HW = 2, 4, 8
ATOL, RTOL = 1e-3, 5e-3
GRAD_ATOL = 1e-3
LR, CUT = 1e-3, 1e-3
# name -> (kwargs of both packages, kwargs of the port alone: the frame size
# that the JAX modules read from their input)
KW = {
    "timesformer": (dict(dimensions=16, patch_size=4), dict(height=HW, width=HW)),
    "performer": ({}, {}),
    "lambda": (dict(dimensions=8), dict(height=HW, width=HW)),
}
NAMES = tuple(KW)


def _clip(seed=0):
    return np.random.default_rng(seed).standard_normal((B, 3, TS, HW, HW)).astype(np.float32)


def _port_model(name, seed=0):
    both, port = KW[name]
    return TR.model_selector(name, timesteps=TS, seed=seed, device="cpu", **both, **port)


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_shapes(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": tuple(v.shape)})
    return out


def _perturb_affines(tree, rng):
    """Add N(0, 0.2^2) to every 1-D leaf, and to the lambda layer's BN
    affines, which init to constants."""
    return {k: _perturb_affines(v, rng) if isinstance(v, dict) else
            (v + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
            if v.ndim == 1 or k.startswith("bn_") else v
            for k, v in sorted(tree.items())}


def _assert_normalised_close(ours, theirs):
    assert set(ours) == set(theirs)
    floor = 1e-3 * max(np.abs(g).max() for g in theirs.values())
    for n, want in theirs.items():
        scale = max(np.abs(want).max(), floor)
        np.testing.assert_allclose(ours[n] / scale, want / scale, rtol=0, atol=GRAD_ATOL,
                                   err_msg=n)


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """(params, logits, grads of sum(logit^2)) of the JAX model on
    ``_clip()``, numpy leaves, from one jit."""
    jm = JR.model_selector(name, timesteps=TS, **KW[name][0])
    params = _perturb_affines(to_jax_params(_port_model(name, seed=3).state_dict()),
                              np.random.default_rng(4))
    shapes = jax.eval_shape(lambda v: jm.init(jax.random.key(1), v), _clip())["params"]
    assert _shapes(shapes) == _shapes(params)

    def run(p, x):
        def loss(q):
            logit = jm.apply({"params": q}, x)[0]
            return jnp.sum(jnp.square(logit)), logit
        (_, logit), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return logit, grads

    logit, grads = jax.jit(run)(params, _clip())
    return params, np.asarray(logit), jax.tree.map(np.asarray, grads)


def _pair(name):
    params = _jax_run(name)[0]
    tm = _port_model(name)
    tm.load_state_dict(state_dict_from_jax(name, params), strict=True)
    return params, tm


# --------------------------------- FAVOR+ -----------------------------------

def _favor_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    qf = rng.uniform(0.01, 1.0, (B, n, 3, 8)).astype(np.float32)
    kf = rng.uniform(0.01, 1.0, (B, n, 3, 8)).astype(np.float32)
    v = rng.standard_normal((B, n, 3, 5)).astype(np.float32)
    return qf, kf, v


@pytest.mark.parametrize("chunk", [1, 7, 8, 24, 64])
def test_causal_linear_attention_matches_jax(chunk):
    """Values and gradients of sum(out^2) w.r.t. qf, kf and v, at chunks
    that do (1, 8, 24) and do not (7, 64 > N) divide N = 24."""
    qf, kf, v = _favor_inputs(24)

    def jloss(*args):
        return jnp.sum(JF.causal_linear_attention(*args, chunk_size=chunk) ** 2)

    want = JF.causal_linear_attention(qf, kf, v, chunk_size=chunk)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(qf, kf, v)
    ts = [torch.from_numpy(a).requires_grad_() for a in (qf, kf, v)]
    out = PF.causal_linear_attention(*ts, chunk_size=chunk)
    grads = torch.autograd.grad(out.square().sum(), ts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5, rtol=1e-4)
    with torch.no_grad():  # no recompute when nothing needs a gradient
        assert torch.equal(PF.causal_linear_attention(*ts, chunk_size=chunk), out.detach())


def test_favor_features_are_stacked_haar_blocks():
    """ceil(m/d) orthogonal d x d blocks with unit-norm rows (not orthogonal
    columns, whose rows would have norm sqrt(d/m))."""
    proj = PI.favor_orthogonal_features(torch.Generator().manual_seed(0), (20, 8))
    assert proj.shape == (20, 8)
    np.testing.assert_allclose(proj.norm(dim=1).numpy(), np.ones(20), atol=1e-5)
    for block in (proj[:8], proj[8:16]):
        np.testing.assert_allclose((block @ block.T).numpy(), np.eye(8), atol=1e-5)
    assert (proj[:8] @ proj[8:16].T).abs().max() > 0.1  # independent blocks


# ---------------------------- the shared pieces ------------------------------

@pytest.mark.parametrize("piece", ["mha", "mlp", "layer_norm"])
def test_shared_pieces_match_jax(piece):
    """_MHA, _MLP (GELU in its tanh form, as jax.nn.gelu's default) and the
    LayerNorm (biased variance, eps 1e-5) against the JAX package's on
    inputs of scale 3, where the two GELU forms part by ~5e-4: atol 1e-5."""
    from pathtracker_torch.models import transformers as PT
    from pathtracker_tpu.models import transformers as JT

    x = 3.0 * np.random.default_rng(6).standard_normal((B, 5, 12)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    if piece == "layer_norm":
        tm = PT._layer_norm(12)
        with torch.no_grad():
            tm.weight.normal_(1.0, 0.2, generator=gen)
            tm.bias.normal_(0.0, 0.2, generator=gen)

        class _LN(nn.Module):
            @nn.compact
            def __call__(self, z):
                return JT._layer_norm(self, "ln", z)

        jm, params = _LN(), {"ln_scale": tm.weight.detach().numpy(),
                             "ln_bias": tm.bias.detach().numpy()}
    else:
        tm = PT._MHA(12, 3, 4, gen) if piece == "mha" else PT._MLP(12, 24, gen)
        jm = JT._MHA(12, 3, 4) if piece == "mha" else JT._MLP(12, 24)
        params = {k.replace(".weight", "_kernel").replace(".bias", "_bias"):
                  v.detach().numpy().T for k, v in tm.state_dict().items()}
    assert _shapes(jax.eval_shape(lambda v: jm.init(jax.random.key(0), v), x)["params"]) \
        == _shapes(params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": params}, x)),
                               atol=1e-5, rtol=1e-5)


# ------------------------------- the models ---------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name):
    _, tm = _pair(name)
    x = torch.from_numpy(_clip())
    with torch.no_grad():
        logit, penalty = tengine.model_step(tm, x, name)
        again, states, gates = tengine.model_step(tm, x, name, test=True)
    assert logit.shape == (B, 1) and torch.equal(penalty, torch.ones(1))
    assert torch.equal(again, logit) and states is None and gates is None
    np.testing.assert_allclose(logit.numpy(), _jax_run(name)[1], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_jax(name):
    _, tm = _pair(name)
    logit = tm(torch.from_numpy(_clip()))[0]
    names, tensors = zip(*tm.named_parameters())
    grads = torch.autograd.grad(logit.square().sum(), tensors, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, tensors)]
    ours = dict(_leaves(to_jax_params(dict(zip(names, grads)))))
    theirs = dict(_leaves(_jax_run(name)[2]))
    if name == "performer":  # a constant to the gradient in both packages
        assert not ours["favor_proj"].any() and not theirs["favor_proj"].any()
    _assert_normalised_close(ours, theirs)


def test_vit_matches_jax():
    """models/vit.py's ViT on [B, H, W, C] images, 16x16 at patch 4, depth
    2: the JAX names and shapes, and the logits."""
    kw = dict(image_size=16, patch_size=4, dim=32, depth=2, heads=2, dim_head=8,
              mlp_dim=64, num_classes=3)
    img = np.random.default_rng(2).standard_normal((B, 16, 16, 3)).astype(np.float32)
    tm = PV.ViT(device="cpu", **kw)
    params = _perturb_affines(to_jax_params(tm.state_dict()), np.random.default_rng(5))
    jm = JV.ViT(**kw)
    assert _shapes(jax.eval_shape(lambda v: jm.init(jax.random.key(0), v), img)["params"]) \
        == _shapes(params)
    assert "encoder" in params and "attn1" in params["encoder"]
    tm.load_state_dict(state_dict_from_jax("transformer", params), strict=True)
    with torch.no_grad():
        logit = tm(torch.from_numpy(img))
    assert logit.shape == (B, 3)
    np.testing.assert_allclose(logit.numpy(), np.asarray(jm.apply({"params": params}, img)),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_checkpoints_load_in_both_packages(name, tmp_path):
    params, tm = _pair(name)
    with torch.no_grad():  # move every weight off the JAX params
        for p in tm.parameters():
            p.add_(0.25)
    ours = dict(_leaves(to_jax_params(tm.state_dict())))
    path = str(tmp_path / "port.pth.tar")
    tckpt.save_checkpoint(path, tm.state_dict(), epoch=2, acc=55.0)
    loaded = dict(_leaves(jckpt.load_params(path, template=params)))
    assert set(loaded) == set(ours)
    for n in ours:
        np.testing.assert_array_equal(loaded[n], ours[n], err_msg=n)

    path = str(tmp_path / "jax.pth.tar")
    jckpt.save_checkpoint(path, params)
    fresh = _port_model(name, seed=1)
    tengine.load_ckpt(fresh, path)
    back = dict(_leaves(to_jax_params(fresh.state_dict())))
    for n, want in _leaves(params):
        np.testing.assert_array_equal(back[n], want, err_msg=n)


# ------------------------------ the train path ------------------------------

def test_performer_train_step_matches_jax():
    """One J.make_train_step and one T.make_train_step update from the same
    weights: the stats, Adam's first update, and favor_proj, which sits in
    both packages' optimizer state with zero moments and does not move."""
    rng = np.random.default_rng(1)
    clips = rng.integers(0, 255, size=(B, TS, HW, HW, 3), dtype=np.uint8)
    labels = np.array([0, 1], dtype=np.uint8)
    params, tm = _pair("performer")
    jm = JR.model_selector("performer", timesteps=TS)
    jparams, jopt, jstats = J.make_train_step(jm, "performer", J.make_optimizer(LR))(
        jax.tree.map(jnp.copy, params), J.make_optimizer(LR).init(params),
        jnp.asarray(clips), jnp.asarray(labels))
    imgs, target = tprepare(torch.as_tensor(clips), torch.as_tensor(labels))
    names, tensors = zip(*tm.named_parameters())
    grads = torch.autograd.grad(
        tmetrics.bce_with_logits(tengine.model_step(tm, imgs, "performer")[0], target),
        tensors, allow_unused=True)
    grads = dict(_leaves(to_jax_params(
        {n: torch.zeros_like(t) if g is None else g for n, g, t in zip(names, grads, tensors)})))
    opt = T.make_optimizer(LR)
    tstats = T.make_train_step(tm, "performer", opt)(clips, labels)
    for key in T.TRAIN_KEYS:
        np.testing.assert_allclose(tstats[key], jstats[key], rtol=1e-3, atol=1e-3, err_msg=key)

    start, ours = dict(_leaves(params)), dict(_leaves(to_jax_params(tm.state_dict())))
    theirs = dict(_leaves(jparams))
    for n, first in start.items():
        dt, dj = ours[n] - first, theirs[n] - first
        clear = np.abs(grads[n]) > CUT * np.abs(grads[n]).max()
        assert not np.any(clear & (np.abs(dt - dj) > 0.1 * LR)), n
    for tree in (ours, theirs):
        np.testing.assert_array_equal(tree["favor_proj"], start["favor_proj"])

    tstate = dict(_leaves(opt.state_dict(list(names))))
    jstate = dict(_leaves(serialization.to_state_dict(jopt)))
    assert set(tstate) == set(jstate)
    for moment in ("0/mu/favor_proj", "0/nu/favor_proj"):
        assert not tstate[moment].any() and not jstate[moment].any()
    np.testing.assert_allclose(tstate["0/mu/attn0_qkv"], jstate["0/mu/attn0_qkv"],
                               atol=1e-6, rtol=1e-3)


def test_train_and_eval_clis_drive_performer(tmp_path, monkeypatch):
    """python -m pathtracker_torch.train and .eval.test_model with --model
    performer: one capped epoch, the rolling checkpoint (which the JAX
    package reads, favor_proj's moments zero in its optimizer state), and
    the held-out eval of it."""
    from pathtracker_torch.eval import test_model as ttm
    from pathtracker_torch.utils.opts import parser as tparser

    monkeypatch.setenv("PATHTRACKER_DATA_ROOT", str(tmp_path / "data"))
    monkeypatch.setenv("PATHTRACKER_SYNTH_TRAIN", "4")
    monkeypatch.setenv("PATHTRACKER_SYNTH_TEST", "4")
    common = ["--model", "performer", "--name", "run", "--length", "4", "--speed", "1",
              "--dist", "1", "-b", "2"]
    args = tparser.parse_args(common + ["--epochs", "1", "--results-dir",
                                        str(tmp_path / "runs")])
    args.device = "cpu"
    result = tloop.main(args, max_steps_per_epoch=1)
    assert np.all(np.isfinite(result["train_log"]["loss"]))
    rolling = os.path.join(tloop.results_folder_for(args), "saved_models",
                           "model_last_epoch_checkpoint.pth.tar")
    state = jckpt.load_checkpoint(rolling)
    moments = state["extra"]["opt_state"]["0"]
    assert not np.any(moments["mu"]["favor_proj"]) and not np.any(moments["nu"]["favor_proj"])
    np.testing.assert_array_equal(state["params"]["favor_proj"]
                                  if "params" in state else state["state_dict"]["favor_proj"],
                                  to_jax_params(tloop.init_model(args, 4).state_dict())[
                                      "favor_proj"])
    eval_args = tparser.parse_args(common + ["--ckpt", rolling])
    eval_args.device = "cpu"
    acc, loss = ttm.evaluate_model(str(tmp_path / "eval"), eval_args, prep_gifs=1,
                                   dist=1, speed=1, length=4)
    assert 0.0 <= acc <= 1.0 and np.isfinite(loss)
