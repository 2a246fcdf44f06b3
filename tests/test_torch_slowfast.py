"""The port's SlowFast family (``slowfast``, ``slowfast_nl``, ``slow``)
against pathtracker_tpu's, on the same seeded inputs and the same weights,
at tiny configs: widths 8-16, one or two bottlenecks a stage, B=2, T=8,
16x16 clips (``slowfast_nl`` and ``slow`` keep their yaml's non-local
blocks at the blocks that exist); the yaml loader, the FAIR pyslowfast
import and export, checkpoints both ways, the engine's pathway split, the
dropout, one train step, and the train and eval CLIs.

The weights are the port's seeded init carried to JAX (``to_jax_params``),
every 1-D leaf (BN affines, biases) moved off its constant init: the final
BN of each bottleneck and the non-local output BN start at zero, which
would make every residual branch exactly zero and leave it uncompared.
Each JAX variant runs once under one ``jax.jit`` (cached, shared by every
test of that variant).

Tolerances:
  * f32 logits: atol 1e-3 / rtol 5e-3, the JAX package's bound for its InT
    against the reference over 5 steps (tests/test_int_parity.py:93);
  * gradients of sum(logit^2) for every parameter, each normalised by its
    largest entry (floored at 1e-3 of the model's largest), atol 1e-3, in
    float64 with the BN statistics widened to f64 in both packages by the
    test, as tests/test_torch_video_resnet.py does: ReLU/BN ResNets have
    chaotic f32 gradients at test shapes (one ReLU input within rounding of
    zero moves a normalised gradient by ~1e-2);
  * the train step (dropout 0 in both packages): its packed stats within
    1e-3, and Adam's first update, lr*g/(|g|+eps), entry by entry within
    0.1*lr wherever the gradient stands clear of rounding (above 1e-3 of
    its parameter's largest entry), but for at most FLIPS entries a
    parameter, as tests/test_torch_tsm_steps.py;
  * cfg parsing, checkpoints and the FAIR import and export: exact.
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
from pathtracker_torch.data.prepare import prepare_batch as tprepare
from pathtracker_torch.models import registry as TR
from pathtracker_torch.models import slowfast as PS
from pathtracker_torch.models import slowfast_cfg as PC
from pathtracker_torch.train import checkpoint as tckpt
from pathtracker_torch.train import loop as tloop
from pathtracker_torch.train import steps as T
from pathtracker_torch.train import torch_import as TI
from pathtracker_torch.train.torch_import import state_dict_from_jax, to_jax_params
from pathtracker_torch.utils import metrics as tmetrics
from pathtracker_tpu import engine as jengine
from pathtracker_tpu.models import registry as JR
from pathtracker_tpu.models import slowfast as JS
from pathtracker_tpu.models import slowfast_cfg as JC
from pathtracker_tpu.train import checkpoint as jckpt
from pathtracker_tpu.train import steps as J
from pathtracker_tpu.train import torch_import as JI
from torch_threads import one_thread  # noqa: F401

B, TS, HW = 2, 8, 16
ATOL, RTOL = 1e-3, 5e-3
GRAD_ATOL = 1e-3
LR, CUT, FLIPS = 1e-3, 1e-3, 2
# name -> constructor kwargs shared by both packages (over the yaml's)
KW = {
    "slowfast": dict(width=16, stage_blocks=(1, 1, 1, 1)),
    "slowfast_nl": dict(width=16, stage_blocks=(1, 2, 2, 1)),
    "slow": dict(width=8, stage_blocks=(1, 2, 1, 1)),
}
NAMES = tuple(KW)


def _clip(seed=0):
    return np.random.default_rng(seed).standard_normal((B, 3, TS, HW, HW)).astype(np.float32)


def _port_model(name, seed=0, **kw):
    return TR.model_selector(name, timesteps=TS, seed=seed, device="cpu", **{**KW[name], **kw})


def _jax_model(name, **kw):
    return JR.model_selector(name, timesteps=TS, **{**KW[name], **kw})


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
    to constants (the zero-init BN scales among them)."""
    return {k: _perturb_affines(v, rng) if isinstance(v, dict) else
            (v + 0.2 * rng.standard_normal(v.shape)).astype(np.float32) if v.ndim == 1 else v
            for k, v in sorted(tree.items())}


def _jax_input(name, x, jm):
    if JR.family(name) == "slowfast":
        return jengine.slowfast_pathways(x, jm.alpha)
    return x


@contextlib.contextmanager
def _f64_norm_statistics():
    """Both packages' SlowFast BNs with their statistics taken in f64 for
    an f64 input (each keeps them in f32 otherwise, as it does)."""
    jax_bn, port_bn = JS.batch_norm, PS.batch_norm

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

    JS.batch_norm, PS.batch_norm = jax_f64, port_f64
    try:
        yield
    finally:
        JS.batch_norm, PS.batch_norm = jax_bn, port_bn


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """(params, f32 logits, f64 grads of sum(logit^2)) of the JAX model on
    ``_clip()``, numpy leaves, from one jit."""
    jm = _jax_model(name)
    params = _perturb_affines(to_jax_params(_port_model(name, seed=3).state_dict()),
                              np.random.default_rng(4))
    x = _clip()
    shapes = jax.eval_shape(lambda v: jm.init(jax.random.key(1), _jax_input(name, v, jm)),
                            x)["params"]
    assert _shapes(shapes) == _shapes(params)

    def run(p, x):
        p64 = jax.tree.map(lambda a: a.astype(jnp.float64), p)
        x64 = x.astype(jnp.float64)
        grads = jax.grad(lambda q: jnp.sum(jnp.square(
            jm.apply({"params": q}, _jax_input(name, x64, jm)))))(p64)
        return jm.apply({"params": p}, _jax_input(name, x, jm)), grads

    with jax.enable_x64(True), _f64_norm_statistics():
        logit, grads = jax.jit(run)(params, x)
    return params, np.asarray(logit), jax.tree.map(np.asarray, grads)


def _pair(name):
    params = _jax_run(name)[0]
    tm = _port_model(name)
    tm.load_state_dict(state_dict_from_jax(name, params), strict=True)
    return params, tm


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name):
    _, tm = _pair(name)
    x = torch.from_numpy(_clip())
    with torch.no_grad():
        logit, penalty = tengine.model_step(tm, x, name)
        again, states, gates = tengine.model_step(tm, x, name, test=True)
    assert logit.shape == (B, 1) and logit.dtype == torch.float32
    assert torch.equal(penalty, torch.ones(1)) and states is None and gates is None
    assert torch.equal(again, logit)
    np.testing.assert_allclose(logit.numpy(), _jax_run(name)[1], atol=ATOL, rtol=RTOL)
    if name == "slowfast_nl":  # the yaml's non-local blocks at res3/res4 block 1
        assert {"nl_res3_1", "nl_res4_1"} <= set(_jax_run(name)[0])


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_jax(name):
    _, tm = _pair(name)
    tm.double()
    x = torch.from_numpy(_clip()).double()
    with _f64_norm_statistics():
        logit = tengine.model_step(tm, x, name)[0]
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


# ------------------------------- the yaml -----------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_default_cfgs_parse_as_jax(name):
    assert os.path.dirname(PC.DEFAULT_CFGS[name]).startswith(
        os.path.dirname(os.path.abspath(TR.__file__)))
    assert PC.load_slowfast_cfg(PC.DEFAULT_CFGS[name]) == \
        JC.load_slowfast_cfg(JC.DEFAULT_CFGS[name])


MALFORMED = {
    "depth": "RESNET:\n  DEPTH: 34\n",
    "arch": "MODEL:\n  ARCH: x3d\n",
    "fast_nonlocal": "NONLOCAL:\n  LOCATION: [[[], [1]], [[], []], [[], []], [[], []]]\n",
    "nonlocal_short": "NONLOCAL:\n  LOCATION: [[[1, 3]], [[]], [[]], [[]]]\n",
    "nonlocal_flat": "NONLOCAL:\n  LOCATION: [[1, 3], [2, 4], [5, 6], [7, 8]]\n",
    "slow_nonlocal_ints": "MODEL:\n  ARCH: slow\nNONLOCAL:\n  LOCATION: [1, 2, 3, 4]\n",
    "strides_scalar": "RESNET:\n  SPATIAL_STRIDES: [1, 2, 2, 2]\n",
    "strides_stages": "RESNET:\n  SPATIAL_STRIDES: [[1, 1], [2, 2]]\n",
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_cfgs_raise_as_jax(case, tmp_path):
    path = tmp_path / f"{case}.yaml"
    path.write_text(MALFORMED[case])
    with pytest.raises(ValueError) as want:
        JC.load_slowfast_cfg(str(path))
    with pytest.raises(ValueError) as got:
        PC.load_slowfast_cfg(str(path))
    assert str(got.value) == str(want.value)


def test_cfg_alpha_drives_the_pathway_split_and_the_name_checks_the_arch(tmp_path):
    path = tmp_path / "a2.yaml"
    path.write_text("SLOWFAST:\n  ALPHA: 2\n  FUSION_KERNEL_SZ: 3\n")
    args = type("A", (), dict(model="slowfast", slowfast_cfg=str(path)))()
    tm = tengine.model_selector(args, TS, device="cpu", width=8, stage_blocks=(1, 1))
    jm = jengine.model_selector(args, TS)
    assert tm.alpha == jm.alpha == 2
    x = _clip()
    slow, fast = tengine.slowfast_pathways(torch.from_numpy(x), tm.alpha)
    jslow, jfast = jengine.slowfast_pathways(jnp.asarray(x), jm.alpha)
    assert slow.shape == (B, 3, TS // 2, HW, HW)
    np.testing.assert_array_equal(slow.numpy(), np.asarray(jslow))
    np.testing.assert_array_equal(fast.numpy(), np.asarray(jfast))
    with torch.no_grad():
        assert tengine.model_step(tm, torch.from_numpy(x), "slowfast")[0].shape == (B, 1)
    with pytest.raises(ValueError, match="MODEL.ARCH") as got:
        PS.build("slow", cfg_path=str(path))
    with pytest.raises(ValueError, match="MODEL.ARCH") as want:
        JS.build("slow", cfg_path=str(path))
    assert str(got.value) == str(want.value)


# ------------------------- checkpoints and FAIR -----------------------------

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


@pytest.mark.parametrize("name", ["slowfast", "slowfast_nl"])
def test_fair_state_dict_imports_and_exports_as_in_jax(name, tmp_path):
    """The JAX package's exporter writes a FAIR pyslowfast state_dict of the
    params; with BN running statistics, DataParallel's prefix and a Kinetics
    head added it loads through both packages' load_params to the same
    tree, the head kept at the template's; the port's own state_dict IS
    that layout, and both exporters give it back bit for bit."""
    params = _jax_run(name)[0]
    fair = JI.export_slowfast_state_dict(params)
    tm = _port_model(name)
    tm.load_state_dict(state_dict_from_jax(name, params))
    assert set(tm.state_dict()) == set(fair)
    for key, value in TI.export_slowfast_state_dict(params).items():
        assert torch.equal(value, fair[key]) and torch.equal(tm.state_dict()[key], value), key

    sd = {f"module.{k}": v for k, v in fair.items()}
    for key in list(fair):
        if key.endswith("bn.weight"):
            base = key[: -len(".weight")]
            sd[f"module.{base}.running_mean"] = torch.zeros_like(fair[key])
            sd[f"module.{base}.num_batches_tracked"] = torch.tensor(5)
    sd["module.head.projection.weight"] = torch.ones(400, fair["head.projection.weight"].shape[1])
    sd["module.head.projection.bias"] = torch.zeros(400)
    path = str(tmp_path / "fair.pyth")
    torch.save(sd, path)
    template = to_jax_params(_port_model(name, seed=7).state_dict())
    got = tckpt.load_params(path, template=template)
    want = jckpt.load_params(path, template=template)
    assert _shapes(got) == _shapes(want)
    for (n, g), (_, w) in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(g, w, err_msg=n)
    assert np.array_equal(got["head_kernel"], template["head_kernel"])
    assert np.array_equal(got["slow_stem"]["kernel"], params["slow_stem"]["kernel"])
    fresh = _port_model(name, seed=7)
    tengine.load_ckpt(fresh, path)
    assert torch.equal(fresh.s1.pathway1_stem.conv.weight, fair["s1.pathway1_stem.conv.weight"])


# ------------------------------ the train path ------------------------------

def test_dropout_runs_only_with_a_generator():
    """Inverted dropout before the head: scale 1/keep on the kept features,
    the same mask from the same generator seed, none without a generator
    (inference and eval), whatever ``module.training`` says."""
    tm = _port_model("slowfast", dropout_rate=0.5)
    x = torch.from_numpy(_clip())
    pathways = tengine.slowfast_pathways(x, tm.alpha)
    with torch.no_grad():
        tm.eval()
        plain = tm(pathways)
        tm.train()
        assert torch.equal(tm(pathways), plain)
        a = tm(pathways, generator=torch.Generator().manual_seed(5))
        b = tm(pathways, generator=torch.Generator().manual_seed(5))
        c = tm(pathways, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, plain) and not torch.equal(a, c)
    feat = torch.ones(4, 1000)
    mask = torch.rand(feat.shape, generator=torch.Generator().manual_seed(9)) < 0.5
    dropped = PS._dropout(feat, 0.5, torch.Generator().manual_seed(9))
    assert torch.equal(dropped, torch.where(mask, feat * 2.0, torch.zeros_like(feat)))
    assert PS._dropout(feat, 0.5, None) is feat


def _stats_and_update(name, clips, labels):
    """(the two packed stats, the port's gradient of the step's loss, and
    the params before and after one Adam step of T.make_train_step and
    J.make_train_step) from the same weights, with dropout 0 in both."""
    params = _jax_run(name)[0]
    jm = _jax_model(name, dropout_rate=0.0)
    tm = _port_model(name, dropout_rate=0.0)
    tm.load_state_dict(state_dict_from_jax(name, params))
    jparams, _, jstats = J.make_train_step(jm, name, J.make_optimizer(LR))(
        jax.tree.map(jnp.copy, params), J.make_optimizer(LR).init(params),
        jnp.asarray(clips), jnp.asarray(labels))
    imgs, target = tprepare(torch.as_tensor(clips), torch.as_tensor(labels))
    names, tensors = zip(*tm.named_parameters())
    grads = torch.autograd.grad(
        tmetrics.bce_with_logits(tengine.model_step(tm, imgs, name)[0], target), tensors)
    tstats = T.make_train_step(tm, name, T.make_optimizer(LR))(clips, labels)
    return (tstats, jstats, dict(_leaves(to_jax_params(dict(zip(names, grads))))),
            dict(_leaves(params)), dict(_leaves(to_jax_params(tm.state_dict()))),
            dict(_leaves(jparams)))


@pytest.mark.parametrize("name", ["slowfast", "slow"])
def test_one_train_step_matches_jax(name):
    rng = np.random.default_rng(1)
    clips = rng.integers(0, 255, size=(B, TS, HW, HW, 3), dtype=np.uint8)
    labels = np.array([0, 1], dtype=np.uint8)
    tstats, jstats, grads, start, ours, theirs = _stats_and_update(name, clips, labels)
    assert tuple(tstats) == T.TRAIN_KEYS == tuple(jstats)
    for key in T.TRAIN_KEYS:
        np.testing.assert_allclose(tstats[key], jstats[key], rtol=1e-3, atol=1e-3, err_msg=key)
    moved = 0.0
    for n, first in start.items():
        dt, dj = ours[n] - first, theirs[n] - first
        rounding = np.spacing(np.abs(first))
        for d in (dt, dj):
            assert np.all(np.abs(d) <= LR * (1 + 1e-5) + rounding), (n, np.abs(d).max())
        clear = np.abs(grads[n]) > CUT * np.abs(grads[n]).max()
        apart = clear & (np.abs(dt - dj) > 0.1 * LR)
        assert np.sum(apart) <= FLIPS, (n, np.sum(apart), np.sum(clear))
        moved = max(moved, np.abs(dt).max())
    assert moved >= 0.5 * LR


def test_train_and_eval_clis_drive_slowfast(tmp_path, monkeypatch):
    """python -m pathtracker_torch.train and .eval.test_model with --model
    slowfast and --slowfast_cfg at a tiny cfg (R50's depth at width 8):
    one capped epoch with dropout live through the step's generator, the
    rolling checkpoint, and the held-out eval of it."""
    from pathtracker_torch.eval import test_model as ttm
    from pathtracker_torch.utils.opts import parser as tparser

    monkeypatch.setenv("PATHTRACKER_DATA_ROOT", str(tmp_path / "data"))
    monkeypatch.setenv("PATHTRACKER_SYNTH_TRAIN", "4")
    monkeypatch.setenv("PATHTRACKER_SYNTH_TEST", "4")
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text("RESNET:\n  WIDTH_PER_GROUP: 8\n")
    common = ["--model", "slowfast", "--name", "run", "--length", "8", "--speed", "1",
              "--dist", "1", "-b", "2", "--slowfast_cfg", str(cfg)]
    args = tparser.parse_args(common + ["--epochs", "1", "--results-dir",
                                        str(tmp_path / "runs")])
    args.device = "cpu"
    result = tloop.main(args, max_steps_per_epoch=1)
    assert len(result["train_log"]["loss"]) == 1
    assert np.all(np.isfinite(result["train_log"]["loss"]))
    rolling = os.path.join(tloop.results_folder_for(args), "saved_models",
                           "model_last_epoch_checkpoint.pth.tar")
    params = jckpt.load_params(rolling)
    assert params["slow_res5_2"]["c"]["kernel"].shape == (1, 1, 1, 64, 256)
    eval_args = tparser.parse_args(common + ["--ckpt", rolling])
    eval_args.device = "cpu"
    acc, loss = ttm.evaluate_model(str(tmp_path / "eval"), eval_args, prep_gifs=1,
                                   dist=1, speed=1, length=8)
    assert 0.0 <= acc <= 1.0 and np.isfinite(loss)


def test_serve_cli_builds_slowfast_from_its_cfg(tmp_path, monkeypatch):
    """python -m pathtracker_torch.eval.serve --model slowfast --slowfast_cfg
    <yaml> exports the yaml's model (here R50's depth at width 8 and alpha
    2), which serves scores; the export itself is stubbed (a traced R50 is
    ~20 s on the CPU, and the export path is tests/test_torch_export.py's)."""
    from pathtracker_torch.eval import serve

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text("RESNET:\n  WIDTH_PER_GROUP: 8\nSLOWFAST:\n  ALPHA: 2\n")
    exported = []
    monkeypatch.setattr(serve, "export_program", lambda model, *a, **k: exported.append(model))
    monkeypatch.setattr(serve, "save_exported",
                        lambda program, path, *a, **k: open(path, "wb").close())
    serve.main(["--model", "slowfast", "--slowfast_cfg", str(cfg), "--length", "4",
                "--out", str(tmp_path / "sf.pt2"), "--device", "cpu"])
    (net,) = exported
    assert net.alpha == 2 and net.head.projection.in_features == 8 * 8 * 4 + 8 * 8 // 8 * 4
    scores = serve.make_inference_fn(net, "slowfast")(np.zeros((2, 4, 32, 32, 3), np.uint8))
    assert scores.shape == (2,) and bool(((scores >= 0) & (scores <= 1)).all())


def test_resident_windows_draw_the_dropout_as_the_train_step_does():
    """--device-data's windows (here the CPU path, one step a window) supply
    the step's generator as make_train_step does: from the same seed, each
    resident step equals make_train_step on the batch it gathers, dropout
    masks included, and the dropout is live (the first step's loss differs
    from the same weights' with no dropout)."""
    from pathtracker_torch.data.resident import make_resident_train_step

    rng = np.random.default_rng(2)
    clips = torch.from_numpy(rng.integers(0, 255, size=(4, TS, HW, HW, 3), dtype=np.uint8))
    labels = torch.tensor([0, 1, 1, 0], dtype=torch.uint8)
    resident, eager, plain = (_port_model("slowfast", dropout_rate=rate) for rate in (0.5, 0.5, 0.0))
    rstep = make_resident_train_step(resident, "slowfast", T.make_optimizer(LR), n_clips=4,
                                     batch_size=2, seed=3)
    estep = T.make_train_step(eager, "slowfast", T.make_optimizer(LR), seed=3)
    first = T.make_train_step(plain, "slowfast", T.make_optimizer(LR), seed=3)(
        clips[rstep.indices(0)], labels[rstep.indices(0)])
    for step in range(2):
        idx = rstep.indices(step)
        got, want = rstep(clips, labels), estep(clips[idx], labels[idx])
        assert got == want, (step, got, want)
        if step == 0:
            assert got["loss"] != first["loss"]
    for (n, a), b in zip(resident.state_dict().items(), eager.state_dict().values()):
        assert torch.equal(a, b), n


def test_pathway_split_takes_the_frames_numpy_and_jax_take():
    """The slow pathway's frames, computed on the device without a host
    copy, are numpy's linspace(0, T-1, T//alpha) rounded down (what the JAX
    package and the reference take) for every T up to 130 and alpha 1-9."""
    for t in range(1, 131):
        clip = torch.arange(t, dtype=torch.float32).reshape(1, 1, t, 1, 1)
        for alpha in range(1, 10):
            slow, fast = tengine.slowfast_pathways(clip, alpha)
            want = np.linspace(0, t - 1, t // alpha).astype(np.int64)
            np.testing.assert_array_equal(slow.reshape(-1).numpy(), want, err_msg=f"{t} {alpha}")
            assert fast is clip
    jslow = jengine.slowfast_pathways(jnp.arange(64.0).reshape(1, 1, 64, 1, 1), 4)[0]
    np.testing.assert_array_equal(tengine.slowfast_pathways(
        torch.arange(64.0).reshape(1, 1, 64, 1, 1), 4)[0].numpy(), np.asarray(jslow))
