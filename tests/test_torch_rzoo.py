"""The rest of the port's recurrent zoo (ops/lstm, stlstm, fflstm, lrcn,
lrcn_last, ffnet) against pathtracker_tpu's modules, on the same seeded
inputs and the same weights, at small
widths: stlstm at hidden 4 with 3x3 cell convs on B=2, T=8, 16x16 clips
(three pools leave one 2x2 frame); fflstm at LSTM width 3, lrcn at width
5, ffnet at 4 channels with 3x3x3 convs, each on B=2, T=4, 8x8 clips.

The weights are the port's seeded init carried to JAX (``to_jax_params``),
every bias and norm affine moved off its constant init, held to the names
and shapes of the JAX module's ``init``; each JAX model
runs once, under one ``jax.jit`` of ``value_and_grad`` that also returns
its logits and its legacy outputs (cached, shared by every test of that
model): JAX's CPU compile is most of these tests' time.

Tolerances:
  * f32 forward (logits, legacy outputs and loss): atol 1e-3 / rtol 5e-3,
    the JAX package's bound for its InT against the reference over 5 steps
    (tests/test_int_parity.py:93);
  * gradients of sum(logit^2) for every parameter, each normalised by its
    largest entry (floored at 1e-3 of the model's largest), atol 1e-3, as
    tests/test_torch_zoo.py;
  * ops/lstm against lstm_apply: atol 1e-5 (f32 sums of a few products
    taken in another order, through tanh and sigmoid);
  * checkpoints: exact.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pathtracker_torch import engine as tengine
from pathtracker_torch.models import registry as TR
from pathtracker_torch.ops import lstm as tlstm
from pathtracker_torch.train import checkpoint as tckpt
from pathtracker_torch.train.steps import make_optimizer, make_train_step
from pathtracker_torch.train.torch_import import state_dict_from_jax, to_jax_params
from pathtracker_tpu.models import registry as JR
from pathtracker_tpu.ops import lstm as jlstm
from pathtracker_tpu.train import checkpoint as jckpt

B = 2
ATOL, RTOL = 1e-3, 5e-3
# name -> (clip T, clip H = W, constructor kwargs shared by both packages)
SHAPES = {
    "stlstm": (8, 16, dict(filt_size=3, hidden=4)),
    "fflstm": (4, 8, dict(hgru_size=3)),
    "lrcn": (4, 8, dict(hidden_size=5)),
    "lrcn_last": (4, 8, dict(hidden_size=5)),
    "ffnet": (4, 8, dict(filt_size=3, width=4)),
}
NAMES = tuple(SHAPES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's LSTMs on the CPU are thousands of tiny steps, each an
    OpenMP region: on a loaded machine (several test workers on its cores)
    their threads wait on each other, and one lrcn CLI test took 203 s with
    torch's default thread count against 15 s with one thread. The module
    runs on one thread and gives the worker its count back after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _clip(name, seed=0):
    t, hw, _ = SHAPES[name]
    return np.random.default_rng(seed).standard_normal((B, 3, t, hw, hw)).astype(np.float32)


def _target(name):
    return np.array([0, 1]) if name == "ffnet" else np.array([0.0, 1.0], np.float32)


def _jax_criterion(name):
    if name == "ffnet":  # cross-entropy over the two class logits
        return lambda out, t: -jnp.mean(jax.nn.log_softmax(out)[jnp.arange(B), t])
    return lambda p, t: -jnp.mean(t * jnp.log(p) + (1 - t) * jnp.log(1 - p))


def _torch_criterion(name):
    if name == "ffnet":
        return lambda out, t: F.cross_entropy(out, torch.as_tensor(t))
    return lambda p, t: F.binary_cross_entropy(p, torch.as_tensor(t))


def _jax_model(name):
    t, _, kw = SHAPES[name]
    return JR.model_selector(name, timesteps=t, **kw)


def _port_model(name, seed=0):
    t, hw, kw = SHAPES[name]
    return TR.model_selector(name, timesteps=t, height=hw,
                             **({"frame_width": hw} if name == "ffnet" else {"width": hw}),
                             seed=seed, device="cpu", **kw)


def _perturb_affines(params, seed=4):
    """Add N(0, 0.2^2) to every bias and norm affine, which init to
    constants (ones and zeros would hide a transposed LayerNorm affine)."""
    rng = np.random.default_rng(seed)

    def walk(tree, prefix=""):
        return {k: walk(v, f"{prefix}{k}/") if isinstance(v, dict) else
                (v + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
                if v.ndim == 1 or "_ln_" in k else v
                for k, v in sorted(tree.items())}

    return walk(params)


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """(params, logits, legacy (outputs, loss), grads of sum(logit^2)) of
    the JAX model on ``_clip(name)``, numpy leaves. The params are the
    port's seeded init in the JAX names and layouts, held to the tree that
    the JAX module's ``init`` makes (names and shapes, from
    ``jax.eval_shape``: running JAX's init costs more than the rest)."""
    jm, x = _jax_model(name), jnp.asarray(_clip(name))
    params = _perturb_affines(to_jax_params(_port_model(name, seed=3).state_dict()))
    shapes = jax.eval_shape(lambda v: jm.init(jax.random.key(1), v), x)["params"]
    assert dict(_leaves(shapes, shape=True)) == dict(_leaves(params, shape=True))
    crit, target = _jax_criterion(name), jnp.asarray(_target(name))

    def loss(p):
        logit = jm.apply({"params": p}, x)[0]
        out, _, legacy_loss = jm.apply({"params": p}, x, target=target, criterion=crit)
        return jnp.sum(jnp.square(logit)), (logit, out, legacy_loss)

    (_, (logit, out, legacy_loss)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return params, np.asarray(logit), (np.asarray(out), float(legacy_loss)), \
        jax.tree.map(np.asarray, grads)


def _pair(name):
    """The JAX params and a port model (another seed's init) loaded with them."""
    params = _jax_run(name)[0]
    tm = _port_model(name)
    tm.load_state_dict(state_dict_from_jax(name, params), strict=True)
    return params, tm


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=msg)


def _leaves(tree, prefix="", shape=False):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/", shape)
        else:
            yield f"{prefix}{k}", tuple(v.shape) if shape else np.asarray(v)


@pytest.mark.parametrize("name", NAMES)
def test_forward_and_legacy_contract_match_jax(name):
    _, tm = _pair(name)
    _, j_logit, (j_out, j_loss), _ = _jax_run(name)
    x = torch.from_numpy(_clip(name))
    with torch.no_grad():
        logit, jv = tm(x)
        out, jv2, loss = tm(x, target=_target(name), criterion=_torch_criterion(name))
    assert logit.shape == (B, 1) and jv.tolist() == [1.0] == jv2.tolist()
    _close(logit, j_logit, msg="logit")
    assert tuple(out.shape) == j_out.shape
    _close(out, j_out, msg="legacy output")
    _close(loss, j_loss, msg="legacy loss")
    # the model_step contract: testmode gives no maps
    with torch.no_grad():
        got = tengine.model_step(tm, x, name, test=True)
    assert got[1] is None and got[2] is None
    _close(got[0], j_logit)


def _grads_close(ours, theirs):
    ours, theirs = dict(_leaves(ours)), dict(_leaves(theirs))
    assert set(ours) == set(theirs)
    floor = 1e-3 * max(np.abs(g).max() for g in theirs.values())
    for n, want in theirs.items():
        got = ours[n]
        assert got.shape == want.shape, n
        scale = max(np.abs(want).max(), floor)
        np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-3, err_msg=n)


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_jax(name):
    _, tm = _pair(name)
    logit, _ = tm(torch.from_numpy(_clip(name)))
    names, tensors = zip(*tm.named_parameters())
    grads = torch.autograd.grad(logit.square().sum(), tensors, allow_unused=True)
    ours = to_jax_params({n: torch.zeros_like(p) if g is None else g
                          for n, p, g in zip(names, tensors, grads)})
    _grads_close(ours, _jax_run(name)[3])


@pytest.mark.parametrize("layers,bidirectional,with_state",
                         [(1, False, False), (1, False, True), (2, True, False),
                          (2, True, True)])
def test_lstm_matches_jax(layers, bidirectional, with_state):
    """ops/lstm against JAX's lax.scan stack: outputs and (h_n, c_n), from
    zero and from a given state, the reverse direction aligned; and the
    path that sequences longer than cuDNN takes run (one layer and
    direction at a time, in pieces of 4 of the 6 steps here) the same."""
    d_in, hidden, steps = 3, 4, 6
    lstm = tlstm.lstm_params(torch.Generator().manual_seed(5), d_in, hidden, layers,
                             bidirectional)
    sd = {k: v.detach().numpy() for k, v in lstm.state_dict().items()}
    jparams = [[{"w_ih": sd[f"weight_ih_l{k}{s}"].T, "w_hh": sd[f"weight_hh_l{k}{s}"].T,
                 "b_ih": sd[f"bias_ih_l{k}{s}"], "b_hh": sd[f"bias_hh_l{k}{s}"]}
                for s in ("", "_reverse")[:1 + bidirectional]] for k in range(layers)]
    rng = np.random.default_rng(6)
    seq = rng.standard_normal((steps, B, d_in)).astype(np.float32)
    n = layers * (1 + bidirectional)
    state = (tuple(rng.standard_normal((n, B, hidden)).astype(np.float32) for _ in range(2))
             if with_state else None)
    j_out, (j_h, j_c) = jlstm.lstm_apply(jparams, jnp.asarray(seq), state)
    with torch.no_grad():
        out, (h, c) = tlstm.lstm_apply(
            lstm, torch.from_numpy(seq),
            tuple(map(torch.from_numpy, state)) if state else None)
        split, (split_h, split_c) = tlstm._by_direction(
            lstm, torch.from_numpy(seq),
            tuple(map(torch.from_numpy, state)) if state else None, chunk=4)
    assert out.shape == (steps, B, hidden * (1 + bidirectional)) and h.shape == (n, B, hidden)
    for got, want in ((out, j_out), (h, j_h), (c, j_c), (split, j_out), (split_h, j_h),
                      (split_c, j_c)):
        _close(got, want, atol=1e-5, rtol=0)
    # the split path's gradients, to the sequence and every weight
    x = torch.from_numpy(seq).requires_grad_()
    grads = []
    for run in (lambda: tlstm.lstm_apply(lstm, x), lambda: tlstm._by_direction(lstm, x, None, 4)):
        y, (h_n, c_n) = run()
        grads.append(torch.autograd.grad((y.square().sum() + h_n.sum() + c_n.square().sum()),
                                         [x, *lstm.parameters()]))
    for got, want in zip(*grads):
        _close(got, want, atol=1e-5, rtol=0)


def test_lstm_init_follows_torch_bounds():
    lstm = tlstm.lstm_params(torch.Generator().manual_seed(0), 3, 16, 2, True)
    assert lstm.batch_first is False and lstm.bidirectional and lstm.num_layers == 2
    for name, p in lstm.named_parameters():
        assert p.abs().max() <= 0.25 and p.std() > 0.1, name  # U(+-1/sqrt(16))


@pytest.mark.parametrize("name", NAMES)
def test_checkpoints_load_in_both_packages(name, tmp_path):
    params, tm = _pair(name)
    with torch.no_grad():  # move every weight off the JAX init
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
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    tengine.load_ckpt(fresh, path)
    back = dict(_leaves(to_jax_params(fresh.state_dict())))
    for n, want in _leaves(params):
        np.testing.assert_array_equal(back[n], want, err_msg=n)


@pytest.mark.parametrize("name", ["stlstm", "fflstm", "lrcn", "ffnet"])
def test_reference_pickles_raise_as_in_jax(name, tmp_path):
    """No importer maps these families' torch pickles, in either package:
    a state_dict of the model saved with torch raises a ValueError."""
    params, tm = _pair(name)
    path = str(tmp_path / "ref.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in tm.state_dict().items()}}, path)
    with pytest.raises(ValueError):
        jckpt.load_params(path, template=params)
    with pytest.raises(ValueError):
        tengine.load_ckpt(_port_model(name), path)


def test_fflstm_stem_stays_frozen_after_a_step():
    """The gaussian stem is a parameter that never moves: JAX stops its
    gradient, the port detaches it; Adam's moments for it stay zero."""
    import optax

    params, tm = _pair("fflstm")
    t, hw, _ = SHAPES["fflstm"]
    raw = np.random.default_rng(7).integers(0, 256, (B, t, hw, hw, 3), dtype=np.uint8)
    labels = np.array([0, 1], np.uint8)
    opt = make_optimizer(1e-2)
    step = make_train_step(tm, "fflstm", opt)
    stem = tm.conv00.weight.detach().clone()
    assert np.isfinite(step(raw, labels)["loss"])
    assert torch.equal(tm.conv00.weight, stem)
    state = opt.state_dict([n for n, _ in tm.named_parameters()])
    assert not state["0"]["mu"]["conv00_kernel"].any()
    assert not state["0"]["nu"]["conv00_kernel"].any()
    assert not torch.equal(tm.fc4.weight, _pair("fflstm")[1].fc4.weight)

    grads = _jax_run("fflstm")[3]
    assert not grads["conv00_kernel"].any()
    tx = optax.adam(1e-2)
    updates, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, updates)
    np.testing.assert_array_equal(np.asarray(new["conv00_kernel"]), params["conv00_kernel"])


def test_registry_builds_the_rest_of_the_zoo():
    kw = dict(timesteps=8, device="cpu")
    assert TR.model_selector("stlstm", **kw).unit1.conv_x[1].weight.shape == (56, 4, 4)
    assert TR.model_selector("fflstm", **kw).fc4.in_features == 8 * 4 * 16 * 16
    assert TR.model_selector("lrcn", **kw).vote and not TR.model_selector("lrcn_last", **kw).vote
    assert TR.model_selector("ffnet", **kw).fc4.in_features == 2 * 8 * 32 * 32
    for name in NAMES:
        assert TR.family(name) == "recurrent"


@pytest.mark.parametrize("name", ["lrcn", "stlstm"])
def test_train_and_eval_clis_drive_the_rest_of_the_zoo(name, tmp_path, monkeypatch):
    """python -m pathtracker_torch.train and .eval.test_model with --model
    <name>: one capped epoch, the rolling checkpoint, and the held-out eval
    of it (no plots: these models return no maps)."""
    from pathtracker_torch.eval import test_model as ttm
    from pathtracker_torch.train import loop as tloop
    from pathtracker_torch.utils.opts import parser as tparser

    monkeypatch.setenv("PATHTRACKER_DATA_ROOT", str(tmp_path / "data"))
    monkeypatch.setenv("PATHTRACKER_SYNTH_TRAIN", "4")
    monkeypatch.setenv("PATHTRACKER_SYNTH_TEST", "4")
    length = 8 if name == "stlstm" else 4
    common = ["--model", name, "--name", "run", "--length", str(length), "--speed", "1",
              "--dist", "1", "-b", "2"]
    args = tparser.parse_args(common + ["--epochs", "1", "--results-dir",
                                        str(tmp_path / "runs")])
    args.device = "cpu"
    result = tloop.main(args, max_steps_per_epoch=1)
    assert len(result["train_log"]["loss"]) == 1
    assert np.all(np.isfinite(result["train_log"]["loss"]))
    rolling = os.path.join(tloop.results_folder_for(args), "saved_models",
                           "model_last_epoch_checkpoint.pth.tar")
    eval_args = tparser.parse_args(common + ["--ckpt", rolling])
    eval_args.device = "cpu"
    acc, loss = ttm.evaluate_model(str(tmp_path / "eval"), eval_args, prep_gifs=1,
                                   dist=1, speed=1, length=length)
    assert 0.0 <= acc <= 1.0 and np.isfinite(loss)
