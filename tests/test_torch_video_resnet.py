"""The port's video ResNets (r3d, mc3, r2plus1 and the four no-stride
forks) against pathtracker_tpu's VideoResNet, on the same seeded inputs and
the same weights, with one block a stage (``layers=(1, 1, 1, 1)``; the
widths are the variants' own) on B=2, T=4 clips (32x32 for r3d, mc3 and
r2plus1, 8x8 for the no-stride forks); the torchvision
checkpoint import of both packages; the train and eval CLIs.

The weights are the port's seeded init carried to JAX (``to_jax_params``),
every BN affine and bias moved off its constant init, held to the names and
shapes of the JAX module's ``init`` (from ``jax.eval_shape``); each JAX
variant runs once, under one ``jax.jit`` of ``value_and_grad`` that also
returns its logits (cached, shared by every test of that variant).

Tolerances:
  * f32 logits: atol 1e-3 / rtol 5e-3, the JAX package's bound for its InT
    against the reference over 5 steps (tests/test_int_parity.py:93);
  * gradients of sum(logit^2) for every parameter, each normalised by its
    largest entry (floored at 1e-3 of the model's largest), atol 1e-3, as
    tests/test_torch_zoo.py; taken in float64 (``dtype='float64'`` in both
    packages, BN statistics in f64 too: both packages keep them in f32 by
    design, and the test widens them for f64 inputs only). In f32 these
    nets are chaotic at the test's shapes: ~10^5-10^6 ReLU inputs, one of
    which may lie within rounding of zero and take the other mask in one
    package than in the other, which moves a normalised weight gradient by
    ~1e-2 (measured with the forks at 16x16: r2plus1 1.8e-2,
    nostride_r3d_cc 1.7e-2 between the packages in f32, and the same with
    f64 convs over f32 BN statistics; 5.8e-8 and 4.6e-8 with f64
    statistics; at these shapes at most 1.7e-8). f64 holds the wiring of
    every gradient without that noise;
  * bf16 (``dtype='bfloat16'``, the whole net in bf16, BN statistics in
    f32): the port's logits within BF16_ATOL of JAX's bf16 logits. Both
    round every conv, BN and residual output to bf16 (2^-8 relative), but
    XLA:CPU fuses elementwise chains and rounds once where PyTorch rounds
    each op (measured: at most 2.9e-3 apart, on logits of 0.002-0.28); each
    package's bf16 logits are also held within BF16_TO_F32 of its own f32
    logits (measured: at most 8.0e-3);
  * checkpoints and the torchvision import: exact.
"""

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracker_torch import engine as tengine
from pathtracker_torch.models import registry as TR
from pathtracker_torch.models import video_resnet as PV
from pathtracker_torch.train import checkpoint as tckpt
from pathtracker_torch.train import loop as tloop
from pathtracker_torch.train.torch_import import state_dict_from_jax, to_jax_params
from pathtracker_tpu.models import registry as JR
from pathtracker_tpu.models import video_resnet as JV
from pathtracker_tpu.train import checkpoint as jckpt

B, T = 2, 4
LAYERS = (1, 1, 1, 1)
ATOL, RTOL = 1e-3, 5e-3
GRAD_ATOL = 1e-3
BF16_ATOL, BF16_TO_F32 = 1e-2, 2e-2
NAMES = ("r3d", "mc3", "r2plus1", "nostride_r3d", "nostride_r3d_cc", "nostride_r3d_pos",
         "nostride_video_cc_small")
TORCHVISION = ("r3d", "mc3", "r2plus1")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """On a loaded machine (several test workers on its cores) torch's
    OpenMP threads wait on each other in every conv: this module took 235 s
    there with torch's default thread count against 97 s with one thread.
    It runs on one thread and gives the worker its count back after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _side(name):
    """32x32 for the strided trunks, as tests/test_video_resnet_oracle.py:35
    (their last stage is then 2x2, and no BN normalises over two values
    alone); 8x8 for the no-stride forks, which keep it."""
    return 32 if name in TORCHVISION else 8


def _clip(name, seed=0):
    c, hw = (5 if TR.needs_coord_channels(name) else 3), _side(name)
    return np.random.default_rng(seed).standard_normal((B, c, T, hw, hw)).astype(np.float32)


def _port_model(name, seed=0, **kw):
    return TR.model_selector(name, timesteps=T, layers=LAYERS, height=_side(name),
                             width=_side(name), seed=seed, device="cpu", **kw)


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
    """Add N(0, 0.2^2) to every 1-D leaf (BN affines, biases), which init
    to constants."""
    return {k: _perturb_affines(v, rng) if isinstance(v, dict) else
            (v + 0.2 * rng.standard_normal(v.shape)).astype(np.float32) if v.ndim == 1 else v
            for k, v in sorted(tree.items())}


@contextlib.contextmanager
def _f64_norm_statistics():
    """Both packages' video ResNets with their BN statistics taken in f64
    for an f64 input (each keeps them in f32 otherwise, as it does)."""
    jax_bn, port_bn = JV.batch_norm, PV.batch_norm

    def jax_f64(x, scale, bias, eps=1e-3, axis_name=None):
        if x.dtype != jnp.float64:
            return jax_bn(x, scale, bias, eps, axis_name)
        axes = tuple(range(x.ndim - 1))
        mean = jnp.mean(x, axes)
        inv = jax.lax.rsqrt(jnp.mean(jnp.square(x), axes) - jnp.square(mean) + eps)
        return (x - mean) * (inv * scale.astype(x.dtype)) + bias.astype(x.dtype)

    def port_f64(x, scale, bias, eps=1e-3):
        if x.dtype != torch.float64:
            return port_bn(x, scale, bias, eps)
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dim=dims)
        inv = torch.rsqrt(x.square().mean(dim=dims) - mean.square() + eps)
        return (x - mean) * (inv * scale.to(x.dtype)) + bias.to(x.dtype)

    JV.batch_norm, PV.batch_norm = jax_f64, port_f64
    try:
        yield
    finally:
        JV.batch_norm, PV.batch_norm = jax_bn, port_bn


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """(params, f32 logits, f64 grads of sum(logit^2), bf16 logits) of the
    JAX variant on ``_clip(name)``, numpy leaves, from one jit."""
    jm, jm16, jm64 = (JR.model_selector(name, timesteps=T, layers=LAYERS, dtype=d)
                      for d in ("float32", "bfloat16", "float64"))
    params = _perturb_affines(to_jax_params(_port_model(name, seed=3).state_dict()),
                              np.random.default_rng(4))
    shapes = jax.eval_shape(lambda v: jm.init(jax.random.key(1), v), _clip(name))["params"]
    assert _shapes(shapes) == _shapes(params)

    def run(p, x):
        grads = jax.grad(lambda q: jnp.sum(jnp.square(jm64.apply({"params": q}, x))))(p)
        return jm.apply({"params": p}, x), grads, jm16.apply({"params": p}, x)

    with jax.enable_x64(True), _f64_norm_statistics():
        logit, grads, logit16 = jax.jit(run)(params, _clip(name))
    return (params, np.asarray(logit), jax.tree.map(np.asarray, grads),
            np.asarray(logit16))


def _pair(name, **kw):
    params = _jax_run(name)[0]
    tm = _port_model(name, **kw)
    tm.load_state_dict(state_dict_from_jax(name, params), strict=True)
    return params, tm


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=msg)


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name):
    _, tm = _pair(name)
    x = torch.from_numpy(_clip(name))
    with torch.no_grad():
        logit = tm(x)
        out, states, gates = tengine.model_step(tm, x, name, test=True)
    assert logit.shape == (B, 1) and logit.dtype == torch.float32
    assert states is None and gates is None and torch.equal(out, logit)
    _close(logit, _jax_run(name)[1])


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_jax(name):
    _, tm = _pair(name, dtype="float64")
    with _f64_norm_statistics():
        logit = tm(torch.from_numpy(_clip(name)))
        names, tensors = zip(*tm.named_parameters())
        grads = torch.autograd.grad(logit.square().sum(), tensors)
    ours = dict(_leaves(to_jax_params(dict(zip(names, grads)))))
    theirs = dict(_leaves(_jax_run(name)[2]))
    assert set(ours) == set(theirs)
    floor = 1e-3 * max(np.abs(g).max() for g in theirs.values())
    for n, want in theirs.items():
        scale = max(np.abs(want).max(), floor)
        np.testing.assert_allclose(ours[n] / scale, want / scale, rtol=0, atol=GRAD_ATOL,
                                   err_msg=n)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_matches_jax(name):
    _, tm = _pair(name, dtype="bfloat16")
    _, j32, _, j16 = _jax_run(name)
    with torch.no_grad():
        logit = tm(torch.from_numpy(_clip(name)))
    assert logit.dtype == torch.float32 and tm.dtype == torch.bfloat16
    assert not np.array_equal(logit.numpy(), j32)
    _close(logit, j16, atol=BF16_ATOL, rtol=0, msg="port bf16 vs JAX bf16")
    _close(logit, j32, atol=BF16_TO_F32, rtol=0, msg="port bf16 vs f32")
    _close(j16, j32, atol=BF16_TO_F32, rtol=0, msg="JAX bf16 vs f32")


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


def _torchvision_state_dict(model, seed):
    """A torchvision-layout state_dict for ``model``'s trunk, seeded: its
    own keys, each BN's running statistics, a 400-class Kinetics fc."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, value in model.state_dict().items():
        if key.startswith("fc."):
            continue
        sd[key] = torch.from_numpy(rng.standard_normal(value.shape).astype(np.float32))
        if value.dim() == 1:  # a BN: the running statistics torchvision keeps
            base = key.rsplit(".", 1)[0]
            sd[f"{base}.running_mean"] = torch.zeros(value.shape)
            sd[f"{base}.running_var"] = torch.ones(value.shape)
            sd[f"{base}.num_batches_tracked"] = torch.tensor(7)
    width = model.fc.in_features
    sd["fc.weight"] = torch.from_numpy(rng.standard_normal((400, width)).astype(np.float32))
    sd["fc.bias"] = torch.zeros(400)
    return sd


@pytest.mark.parametrize("name", TORCHVISION)
def test_torchvision_checkpoint_imports_as_in_jax(name, tmp_path, monkeypatch):
    """A torchvision r3d_18 / mc3_18 / r2plus1d_18 state_dict (seeded, with
    BN running statistics and the Kinetics head) through load_params and
    through --pretrained, in both packages: the same tree, the head kept at
    the model's own init."""
    from pathtracker_tpu.train import loop as jloop

    model = _port_model(name, seed=5)
    template = to_jax_params(model.state_dict())
    sd = _torchvision_state_dict(model, seed=6)
    path = str(tmp_path / "tv.pth")
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    want = dict(_leaves(jckpt.load_params(path, template=template)))
    got = dict(_leaves(tckpt.load_params(path, template=template)))
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    assert np.array_equal(got["fc_kernel"], template["fc_kernel"])
    np.testing.assert_array_equal(got["stem/kernel" if name != "r2plus1" else "stem_s/kernel"],
                                  sd["stem.0.weight"].numpy().transpose(2, 3, 4, 1, 0))

    monkeypatch.setenv("PATHTRACKER_PRETRAINED_DIR", str(tmp_path))
    torch.save(sd, str(tmp_path / {"r3d": "r3d_18.pth", "mc3": "mc3_18.pth",
                                   "r2plus1": "r2plus1d_18.pth"}[name]))
    want = dict(_leaves(jloop.load_pretrained(template, name)))
    assert tloop.load_pretrained(model, name) is model
    got = dict(_leaves(to_jax_params(model.state_dict())))
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_registry_and_engine_build_the_family():
    kw = dict(timesteps=T, layers=LAYERS, device="cpu")
    assert TR.model_selector("r2plus1", **kw).layer2[0].conv1[0][0].weight.shape == \
        (230, 64, 1, 3, 3)
    assert TR.model_selector("nostride_video_cc_small", **kw).fc.in_features == 32 * 32
    for name in NAMES:
        assert TR.family(name) == "torchvision"
        args = type("A", (), dict(model=name, bf16=True))()
        assert tengine.model_selector(args, T, device="cpu", layers=LAYERS).dtype == \
            torch.bfloat16
    with pytest.warns(UserWarning, match="pretrained input normalization"):
        TR.model_selector("nostride_r3d", pretrained=True, **kw)


@pytest.mark.parametrize("name", ["r3d", "nostride_r3d_cc"])
def test_train_and_eval_clis_drive_the_family(name, tmp_path, monkeypatch):
    """python -m pathtracker_torch.train and .eval.test_model with --model
    <name> at the registry's width: one capped epoch, the rolling
    checkpoint, and the held-out eval of it (nostride_r3d_cc takes its
    coord channels from the batch prep)."""
    from pathtracker_torch.eval import test_model as ttm
    from pathtracker_torch.utils.opts import parser as tparser

    monkeypatch.setenv("PATHTRACKER_DATA_ROOT", str(tmp_path / "data"))
    monkeypatch.setenv("PATHTRACKER_SYNTH_TRAIN", "4")
    monkeypatch.setenv("PATHTRACKER_SYNTH_TEST", "4")
    common = ["--model", name, "--name", "run", "--length", "4", "--speed", "1",
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
                                   dist=1, speed=1, length=4)
    assert 0.0 <= acc <= 1.0 and np.isfinite(loss)
