"""The port's recurrent zoo (fc, the hGRU family, gru, convlstm) against
pathtracker_tpu's modules, on the same seeded inputs and the same weights
(carried JAX -> port with ``state_dict_from_jax``), at the shapes of
tests/test_int_parity.py (B=3, C=8, T=5, H=W=12, K=5; gru at twice a width
of 4, as the registry builds it; ConvLSTM on 8x8 images, 4 hidden channels,
3x3 gates, T=3).

Tolerances:
  * f32 forward (logits, testmode states and gates, ConvLSTM maps and
    penalty): atol 1e-3 / rtol 5e-3, the bound the JAX package holds its
    InT to against the reference over 5 steps (tests/test_int_parity.py:93);
  * gradients of sum(logit^2) for every parameter, each normalised by its
    largest entry: atol 1e-3, as tests/test_torch_int_grad.py. The floor of
    the normalisation is 1e-3 of the model's largest gradient entry: the
    preproc bias of fc and clock_hgru feeds a batch-stat BN, which cancels
    it, so its exact gradient is zero and both packages give rounding noise
    (~4e-6 against fc's largest entry, 7);
  * the mixed hGRU (--bf16): its logits within 2e-2 of the f32 ones, in
    both packages alike (a bf16 rounding of each gate and conv product,
    2^-8 relative, carried over 5 steps), and the port's within 1e-2 of
    JAX's mixed logits;
  * checkpoints: exact.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracker_torch import engine as tengine
from pathtracker_torch.models import registry as TR
from pathtracker_torch.train import checkpoint as tckpt
from pathtracker_torch.train.torch_import import state_dict_from_jax, to_jax_params
from pathtracker_tpu.models import registry as JR
from pathtracker_tpu.train import checkpoint as jckpt

B, C, T, HW, K = 3, 8, 5, 12, 5
CONVLSTM_T = 3
VIDEO = ("fc", "hgru", "hgru_v2", "clock_hgru", "clock_hgru_fixed", "gru")
ATOL, RTOL = 1e-3, 5e-3


def _clip(seed=0):
    return np.random.default_rng(seed).standard_normal((B, 3, T, HW, HW)).astype(np.float32)


def _image(seed=0):
    return np.random.default_rng(seed).standard_normal((B, 1, 8, 8)).astype(np.float32)


def _kwargs(name):
    if name == "convlstm":
        return dict(timesteps=CONVLSTM_T), dict(hidden=4, filt_size=3)
    dims = C // 2 if name == "gru" else C
    kw = dict(timesteps=T, dimensions=dims, fb_kernel_size=K)
    extra = dict(height=HW, width=HW) if name in ("fc", "clock_hgru", "clock_hgru_fixed") else {}
    return kw, extra


@functools.lru_cache(maxsize=None)
def _init(name, shape, model_kw):
    """The JAX module's init (its params do not depend on grad_method or
    dtype), once per model and input shape: JAX's eager init is most of
    these tests' time."""
    kw, extra = _kwargs(name)
    kw = {**kw, **(extra if name == "convlstm" else {}), **dict(model_kw)}
    jm = JR.model_selector(name, **kw)
    params = jm.init(jax.random.key(1), jnp.zeros(shape, jnp.float32))["params"]
    return {n: np.asarray(v) for n, v in params.items()}


def _pair(name, seed=0, **model_kw):
    kw, extra = _kwargs(name)
    x = _image(seed) if name == "convlstm" else _clip(seed)
    if name == "convlstm":
        model_kw = {**extra, **model_kw}
        extra = {}
    jm = JR.model_selector(name, **kw, **model_kw)
    static = tuple((k, v) for k, v in model_kw.items()
                   if k not in ("grad_method", "dtype", "hidden", "filt_size"))
    params = dict(_init(name, x.shape, static))
    tm = TR.model_selector(name, device="cpu", **kw, **extra, **model_kw)
    tm.load_state_dict(state_dict_from_jax(name, params), strict=True)
    return jm, params, tm, x


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=msg)


@pytest.mark.parametrize("name", VIDEO)
def test_forward_and_testmode_match_jax(name):
    jm, params, tm, x = _pair(name)
    j_logit, _ = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        t_logit, t_jv = tm(torch.from_numpy(x))
        t_out = tm(torch.from_numpy(x), testmode=True)
    assert t_logit.shape == (B, 1) and t_jv.shape == (1,)
    _close(t_logit, j_logit, msg="logit")
    _close(t_out[0], j_logit, msg="testmode logit")
    if name == "fc":  # a probe: no states, no gates
        assert t_out[1] is None and t_out[2] is None
        return
    j_out = jm.apply({"params": params}, jnp.asarray(x), testmode=True)
    for got, want, what in zip(t_out[1:], j_out[1:], ("states", "gates")):
        assert tuple(got.shape) == want.shape, what
        _close(got, want, msg=what)


def _grads_close(ours, theirs):
    assert set(ours) == set(theirs)
    floor = 1e-3 * max(np.abs(g).max() for g in theirs.values())
    for name, want in theirs.items():
        got = ours[name]
        assert got.shape == want.shape, name
        scale = max(np.abs(want).max(), floor)
        np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-3,
                                   err_msg=name)


def _torch_grads(tm, loss):
    names, tensors = zip(*tm.named_parameters())
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    return to_jax_params({n: torch.zeros_like(p) if g is None else g
                          for n, p, g in zip(names, tensors, grads)})


@pytest.mark.parametrize("name", VIDEO)
def test_train_step_gradients_match_jax(name):
    jm, params, tm, x = _pair(name, seed=4)

    def loss(p):
        return jnp.sum(jnp.square(jm.apply({"params": p}, jnp.asarray(x))[0]))

    want = {n: np.asarray(g) for n, g in jax.grad(loss)(params).items()}
    logit, _ = tm(torch.from_numpy(x))
    _grads_close(_torch_grads(tm, logit.square().sum()), want)


@pytest.mark.parametrize("name", ["hgru", "gru"])
def test_mixed_policy_matches_jax(name):
    jm, params, tm, x = _pair(name, seed=2, dtype="bfloat16")
    assert tm.mxu == torch.bfloat16
    j_mixed = np.asarray(jm.apply({"params": params}, jnp.asarray(x))[0])
    _, _, tf32, _ = _pair(name, seed=2)
    with torch.no_grad():
        t_mixed = tm(torch.from_numpy(x))[0].numpy()
        t_f32 = tf32(torch.from_numpy(x))[0].numpy()
    assert not np.array_equal(t_mixed, t_f32)
    _close(t_mixed, t_f32, atol=2e-2, rtol=0)
    _close(t_mixed, j_mixed, atol=1e-2, rtol=0)


def test_clock_masks_match_jax():
    """'fixed': channel groups with periods 1, 2, 4 (T=5 gives 2 groups);
    'dynamic': sigmoid(clock_rate) on every step."""
    _, _, tm, _ = _pair("clock_hgru_fixed")
    masks = tm.clock_masks(T, torch.device("cpu"))
    want = np.zeros((T, C), np.float32)
    want[:, :C // 2] = 1.0
    want[::2, C // 2:] = 1.0
    np.testing.assert_array_equal(masks.numpy(), want)
    _, _, tm, _ = _pair("clock_hgru")
    np.testing.assert_allclose(tm.clock_masks(T, torch.device("cpu")).detach().numpy(),
                               np.full((T, C), 1 / (1 + np.exp(-2.0)), np.float32), rtol=1e-6)


@pytest.mark.parametrize("grad_method", ["bptt", "rbp"])
def test_convlstm_matches_jax(grad_method):
    """The legacy contract, the Jacobian penalty (BPTT) and RBP: outputs,
    penalty, testmode maps, and gradients of mean(out^2) (+ the penalty under
    BPTT), as tests/test_model_zoo.py:90-110 drives the JAX model. (mean(out)
    itself would not do: the output is a batch-stat BN and a 1x1 conv, so its
    mean does not depend on anything upstream of the BN.)"""
    jm, params, tm, x = _pair("convlstm", grad_method=grad_method)
    j_out, j_jv = jm.apply({"params": params}, jnp.asarray(x))
    t_out, t_jv = tm(torch.from_numpy(x))
    assert t_out.shape == (B, 2, 8, 8)
    _close(t_out.detach(), j_out, msg="output")
    _close(t_jv.detach(), j_jv, msg="penalty")
    if grad_method == "bptt":
        assert float(t_jv.detach()) != 1.0
    else:
        assert float(t_jv.detach()) == 1.0

    def loss(p):
        out, jv = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.mean(jnp.square(out)) + (jnp.sum(jv) if grad_method == "bptt" else 0.0)

    want = {n: np.asarray(g) for n, g in jax.grad(loss)(params).items()}
    total = t_out.square().mean() + (t_jv.sum() if grad_method == "bptt" else 0.0)
    _grads_close(_torch_grads(tm, total), want)

    crit = torch.nn.functional.mse_loss
    target = torch.zeros((B, 2, 8, 8))
    with torch.no_grad():
        out, states, loss_v = tm(torch.from_numpy(x), target=target, criterion=crit,
                                 testmode=True)
    j_states = jm.apply({"params": params}, jnp.asarray(x), testmode=True)[1]
    assert len(states) == len(j_states) == CONVLSTM_T
    for got, want_s in zip(states, j_states):
        _close(got, want_s, msg="states")
    _close(loss_v, crit(out, target), atol=0, rtol=0)


def test_convlstm_stem_is_the_serre_bank():
    from pathtracker_torch.ops import gabor as tgabor
    from pathtracker_tpu.ops import gabor as jgabor

    np.testing.assert_array_equal(tgabor.gabor_serre_bank(), jgabor.gabor_serre_bank())
    for args in [(25, 7, 1), (6, 5, 1), (4, 7, 3), (3, 1, 1)]:
        np.testing.assert_array_equal(tgabor.gabor_bank(*args), jgabor.gabor_bank(*args))
    _, params, _, _ = _pair("convlstm")
    fresh = TR.model_selector("convlstm", timesteps=CONVLSTM_T, hidden=4, filt_size=3,
                              device="cpu")
    np.testing.assert_array_equal(to_jax_params(fresh.state_dict())["conv0_kernel"],
                                  params["conv0_kernel"])


@pytest.mark.parametrize("name", VIDEO + ("convlstm",))
def test_checkpoints_load_in_both_packages(name, tmp_path):
    _, params, tm, _ = _pair(name)
    with torch.no_grad():  # move every weight off the JAX init
        for p in tm.parameters():
            p.add_(0.25)
    ours = to_jax_params(tm.state_dict())
    path = str(tmp_path / "port.pth.tar")
    tckpt.save_checkpoint(path, tm.state_dict(), epoch=2, acc=55.0)
    loaded = jckpt.load_params(path, template=params)
    assert set(loaded) == set(ours)
    for n in ours:
        np.testing.assert_array_equal(np.asarray(loaded[n]), ours[n], err_msg=n)

    path = str(tmp_path / "jax.pth.tar")
    jckpt.save_checkpoint(path, params)
    _, _, fresh, _ = _pair(name, seed=1)
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    tengine.load_ckpt(fresh, path)
    back = to_jax_params(fresh.state_dict())
    for n in params:
        np.testing.assert_array_equal(back[n], params[n], err_msg=n)


@pytest.mark.parametrize("name", ["hgru", "hgru_v2", "gru", "convlstm"])
def test_reference_pickles_load_as_in_jax(name, tmp_path):
    """A reference torch state_dict (the port's modules are its layout),
    DataParallel-prefixed; FFhGRU's defined-but-unused wrapper ``bn``
    (reference ffhgru_hierarchy.py:186) is dropped where the model has none."""
    _, params, tm, _ = _pair(name, seed=3)
    with torch.no_grad():
        for p in tm.parameters():
            p.mul_(0.5)
    sd = {f"module.{k}": v.clone() for k, v in tm.state_dict().items()}
    if name.startswith("hgru"):
        sd["module.bn.weight"], sd["module.bn.bias"] = torch.ones(C), torch.zeros(C)
    path = str(tmp_path / "ref.pth.tar")
    torch.save({"state_dict": sd}, path)
    _, _, fresh, _ = _pair(name, seed=1)
    template = to_jax_params(fresh.state_dict())
    tengine.load_ckpt(fresh, path)
    want = jckpt.load_params(path, template=params)
    got = to_jax_params(fresh.state_dict())
    assert set(got) == set(want) == set(template)
    for n in want:
        np.testing.assert_array_equal(got[n], np.asarray(want[n]), err_msg=n)
        np.testing.assert_array_equal(got[n], to_jax_params(tm.state_dict())[n], err_msg=n)


def test_registry_builds_the_zoo_and_refuses_the_rest():
    kw = dict(timesteps=T, dimensions=C, fb_kernel_size=K, device="cpu")
    assert TR.model_selector("gru", **kw).dimensions == 2 * C
    assert TR.model_selector("clock_hgru_fixed", **kw).clock_type == "fixed"
    for name in ("stlstm", "fflstm", "lrcn", "lrcn_last", "ffnet"):
        assert TR.family(name) == "recurrent"
        assert TR.model_selector(name, **kw).training
    tiny = {"slowfast": dict(width=8, stage_blocks=(1, 1)),
            "slowfast_nl": dict(width=8, stage_blocks=(1, 1)),
            "slow": dict(width=8, stage_blocks=(1, 1)),
            "timesformer": {}, "performer": {}, "lambda": dict(height=4, width=4)}
    for name, extra in tiny.items():
        m = TR.model_selector(name, timesteps=T, device="cpu", **extra)
        assert m.training and next(m.parameters()).device == torch.device("cpu")
    assert TR.model_selector("slow", timesteps=T, device="cpu", width=8,
                             stage_blocks=(1, 1)).head.projection.out_features == 1
    args = type("A", (), dict(model="convlstm", algo="bptt"))()
    with pytest.raises(NotImplementedError, match="legacy"):
        tengine.model_selector(args, T, device="cpu")
    args = type("A", (), dict(model="hgru", algo="rbp"))()
    with pytest.raises(NotImplementedError, match="InT"):
        tengine.model_selector(args, T, device="cpu")
    assert os.path.basename(tengine.__file__) == "engine.py"


@pytest.mark.parametrize("name", ["fc", "hgru", "hgru_v2", "clock_hgru", "gru"])
def test_train_and_eval_clis_drive_the_zoo(name, tmp_path, monkeypatch):
    """python -m pathtracker_torch.train and .eval.test_model with --model
    <name> and no other new flag: one capped epoch, the rolling checkpoint,
    and the held-out eval of it with its plots (none for fc, which has no
    states, and hgru_v2, whose states have C channels)."""
    from pathtracker_torch.eval import test_model as ttm
    from pathtracker_torch.train import loop as tloop
    from pathtracker_torch.utils.opts import parser as tparser

    monkeypatch.setenv("PATHTRACKER_DATA_ROOT", str(tmp_path / "data"))
    monkeypatch.setenv("PATHTRACKER_SYNTH_TRAIN", "4")
    monkeypatch.setenv("PATHTRACKER_SYNTH_TEST", "4")
    common = ["--model", name, "--name", "run", "--length", "4", "--speed", "1",
              "--dist", "1", "-b", "2", "-d", "4", "-k", "3"]
    args = tparser.parse_args(common + ["--epochs", "1", "--results-dir",
                                        str(tmp_path / "runs")])
    args.device = "cpu"
    result = tloop.main(args, max_steps_per_epoch=1)
    assert len(result["train_log"]["loss"]) == 1
    assert np.all(np.isfinite(result["train_log"]["loss"]))
    rolling = os.path.join(tloop.results_folder_for(args), "saved_models",
                           "model_last_epoch_checkpoint.pth.tar")
    assert os.path.exists(rolling)
    eval_args = tparser.parse_args(common + ["--ckpt", rolling])
    eval_args.device = "cpu"
    acc, loss = ttm.evaluate_model(str(tmp_path / "eval"), eval_args, prep_gifs=1,
                                   dist=1, speed=1, length=4)
    assert 0.0 <= acc <= 1.0 and np.isfinite(loss)
    gifs = [f for _, _, names in os.walk(tmp_path / "eval") for f in names
            if f.endswith(".gif")]
    assert len(gifs) == (0 if name in ("fc", "hgru_v2") else 1)
