"""Checkpoints cross between the packages: the port's msgpack writer against
flax's bytes, the port's checkpoints read by pathtracker_tpu, reference
torch pickles read by both, the optimizer state in the optax layout both
ways, and the small numpy-only modules of the loop (meters, grad tools,
early stopping) against the JAX package's.

Tolerances: weights and trees are held exactly (the mappings only rename
and transpose); optimizer moments at tests/test_torch_steps.py::
test_optimizer_matches_optax's rtol 1e-5 (the same f32 gradients through
two Adam implementations)."""

import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from pathtracker_torch import engine as tengine
from pathtracker_torch.models import tsm_resnet as TM
from pathtracker_torch.models.int_circuit import InT
from pathtracker_torch.train import checkpoint as tckpt
from pathtracker_torch.train import steps as T
from pathtracker_torch.train.torch_import import state_dict_from_jax, to_jax_params
from pathtracker_torch.utils import gradtools as tgrad
from pathtracker_torch.utils.earlystopping import EarlyStopping as TEarlyStopping
from pathtracker_torch.utils.meters import AverageMeter as TMeter
from pathtracker_tpu.models import tsm_resnet as JM
from pathtracker_tpu.train import checkpoint as jckpt
from pathtracker_tpu.train import steps as J
from pathtracker_tpu.train import torch_import as JI
from pathtracker_tpu.utils import gradtools as jgrad
from pathtracker_tpu.utils.earlystopping import EarlyStopping as JEarlyStopping
from pathtracker_tpu.utils.meters import AverageMeter as JMeter

DIMS, T_STEPS, K = 4, 3, 3
TSM_KW = dict(layers=(1, 1, 1, 1), patch=5)


def _int(seed=0):
    return InT(dimensions=DIMS, timesteps=T_STEPS, kernel_size=K, seed=seed, device="cpu")


def _tsm(seed=0):
    return TM.TSMResNet(seed=seed, device="cpu", **TSM_KW)


@functools.cache
def _tsm_template():
    """The JAX rntsm's params as an ``eval_shape`` tree: nothing compiled."""
    return jax.eval_shape(
        lambda a: JM.TSMResNet(**TSM_KW).init(jax.random.key(0), a),
        jax.ShapeDtypeStruct((1, 3, 2, 8, 8), jnp.float32))["params"]


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}/{i}")
    else:
        assert type(got) is type(want) or isinstance(want, np.ndarray), (path, type(got), type(want))
        if isinstance(want, (np.ndarray, np.generic)):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)
        else:  # None, bool, int, float, str, bytes
            assert got == want, (path, got, want)


# ------------------------------ msgpack bytes -------------------------------

_EDGE_INTS = [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
              -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
TREES = {
    "nested": {"a": {"b": {"c": np.arange(6, dtype=np.float32).reshape(2, 3)}},
               "z": np.zeros((2, 0, 3), np.float32)},
    "dtypes": {"f32": np.linspace(-1, 1, 7, dtype=np.float32),
               "i32": np.arange(-3, 4, dtype=np.int32),
               "u8": np.arange(250, 256, dtype=np.uint8).reshape(2, 3),
               "f64": np.array([np.pi, -np.e])},
    # A 0-d float32 array packs to 16 bytes: flax frames it as fixext 16.
    "zero-d": {"f": np.asarray(1.5, np.float32), "i": np.asarray(7, np.int32),
               "d": np.asarray(2.0), "count": np.asarray(3, np.int32)},
    "scalars": {"g": np.float32(1.25), "h": np.int64(-7), "b": np.bool_(True)},
    "empty": {"e": {}, "x": {"y": {}}},
    "ints": {"ints": _EDGE_INTS},
    "python": {"f": [0.0, -1.5, 1e300, float("inf")], "s": "text", "n": None,
               "t": True, "u": False, "bin": b"\x00\x01"},
    "lengths": {"s": ["", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "a" * 65535,
                      "a" * 65536],
                "bin": [b"x" * 255, b"x" * 256, b"x" * 65536],
                "ext": [np.zeros(n, np.uint8) for n in (200, 300, 70000)],
                "list": [list(range(15)), list(range(16))]},
    "map-15": {f"k{i}": i for i in range(15)},
    "map-16": {f"k{i}": i for i in range(16)},
    "map-256": {f"k{i}": i for i in range(256)},
    "map-65536": {f"k{i:05d}": None for i in range(65536)},
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_packb_is_byte_equal_to_flax_and_round_trips(name):
    tree = TREES[name]
    blob = tckpt.packb(tree)
    assert blob == serialization.msgpack_serialize(tree)
    _assert_trees_equal(tckpt.unpackb(blob), serialization.msgpack_restore(blob))
    _assert_trees_equal(serialization.msgpack_restore(blob), tree)


def test_packb_refuses_what_flax_does_not_write():
    for bad in ({"o": object()}, {"a": np.array([object()])}):
        with pytest.raises((TypeError, ValueError)):
            tckpt.packb(bad)


# --------------------------- port checkpoints in JAX ------------------------

def test_port_int_checkpoint_loads_in_jax(tmp_path):
    model = _int()
    path = str(tmp_path / "int.pth.tar")
    tckpt.save_checkpoint(path, model.state_dict(), epoch=3, acc=61.5,
                          extra={"note": "x", "n": 2})
    want = to_jax_params(model.state_dict())
    template = to_jax_params(_int(seed=1).state_dict())
    _assert_trees_equal(jckpt.load_params(path, template=template), want)
    state = jckpt.load_checkpoint(path)
    assert state["epoch"].shape == () and state["epoch"].dtype == np.int64
    assert state["acc"].shape == () and float(state["acc"]) == 61.5
    assert state["extra"] == {"note": "x", "n": 2}
    # The same file through the port's reader and into another model.
    other = _int(seed=1)
    tengine.load_ckpt(other, path)
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    assert not os.path.exists(path + ".tmp")


def test_port_rntsm_checkpoint_loads_in_jax(tmp_path):
    model = _tsm()
    path = str(tmp_path / "tsm.pth.tar")
    tckpt.save_checkpoint(path, model.state_dict())
    loaded = jckpt.load_params(path, template=_tsm_template())
    _assert_trees_equal(loaded, to_jax_params(model.state_dict()))


# ------------------------- reference torch pickles --------------------------

def _reference_state(kind):
    sd = {k: v.clone() for k, v in _int(seed=2).state_dict().items()}
    if kind == "module":
        # DataParallel's prefix, and FFhGRU's dead wrapper BN.
        sd = {f"module.{k}": v for k, v in sd.items()}
        sd["module.bn.weight"], sd["module.bn.bias"] = torch.ones(DIMS), torch.zeros(DIMS)
    return {"state_dict": sd} if kind == "wrapped" else sd


@pytest.mark.parametrize("kind", ["raw", "wrapped", "module", "legacy"])
def test_reference_pickles_load_as_in_jax(tmp_path, kind):
    path = str(tmp_path / f"{kind}.pth.tar")
    torch.save(_reference_state(kind), path,
               _use_new_zipfile_serialization=kind != "legacy")
    with open(path, "rb") as f:
        head = f.read(2)
    assert (head == b"PK") == (kind != "legacy")
    model = _int(seed=5)
    template = to_jax_params(model.state_dict())
    tengine.load_ckpt(model, path)
    want = jckpt.load_params(path, template=template)
    _assert_trees_equal(to_jax_params(model.state_dict()), want)
    _assert_trees_equal(want, to_jax_params(_int(seed=2).state_dict()))


def test_reference_pickle_strict_false_and_unmapped_keys(tmp_path):
    sd = _reference_state("raw")
    partial = {k: v for k, v in sd.items() if k not in ("unit1.w", "unit1.mu")}
    path = str(tmp_path / "partial.pth.tar")
    torch.save(partial, path)
    model = _int(seed=5)
    template = to_jax_params(model.state_dict())
    with pytest.raises(ValueError, match="missing"):
        tengine.load_ckpt(_int(seed=5), path)
    tengine.load_ckpt(model, path, strict=False)
    _assert_trees_equal(to_jax_params(model.state_dict()),
                        jckpt.load_params(path, template=template, strict=False))
    assert torch.equal(model.unit1.w, _int(seed=5).unit1.w)

    torch.save({**sd, "foo.weight": torch.zeros(3)}, path)
    with pytest.raises(ValueError, match="foo.weight"):
        tengine.load_ckpt(_int(), path)
    with pytest.raises(ValueError):
        jckpt.load_params(path, template=template)


class _NotAWeight:
    pass


def test_pickle_refused_by_weights_only_raises_with_the_path(tmp_path):
    path = str(tmp_path / "unsafe.pth.tar")
    torch.save({"state_dict": {"x": _NotAWeight()}}, path)
    with pytest.raises(pickle.UnpicklingError, match="unsafe.pth.tar"):
        tckpt.load_checkpoint(path)


def test_torchvision_resnet_trunk_imports_into_rntsm_as_jax(tmp_path):
    """A plain torchvision ResNet state dict (no MotionSqueeze, a 1000-class
    Linear fc, BN running statistics), built from the port's own rntsm,
    loads its trunk with strict=False as the JAX importer does; the head is
    skipped and the MotionSqueeze keeps the model's values."""
    src = _tsm(seed=3).state_dict()
    trunk = {k: v.clone() for k, v in src.items()
             if not k.startswith(("chnl_reduction", "flow_refinement", "fc1"))}
    for k in [k for k in trunk if k.endswith("bn1.weight")]:
        base = k[: -len("weight")]
        trunk[base + "running_mean"] = torch.zeros_like(trunk[k])
        trunk[base + "running_var"] = torch.ones_like(trunk[k])
        trunk[base + "num_batches_tracked"] = torch.tensor(5)
    c = src["fc1.weight"].shape[1]
    trunk["fc.weight"], trunk["fc.bias"] = torch.randn(1000, c), torch.randn(1000)
    path = str(tmp_path / "imagenet.pth")
    torch.save(trunk, path)
    model = _tsm(seed=4)
    template = to_jax_params(model.state_dict())
    with pytest.raises(ValueError, match="missing"):
        tengine.load_ckpt(_tsm(seed=4), path)
    tengine.load_ckpt(model, path, strict=False)
    want = JI.import_tsm_resnet_state_dict(torch.load(path), template, strict=False)
    _assert_trees_equal(to_jax_params(model.state_dict()), want)
    assert torch.equal(model.layer1[0].conv1.weight, src["layer1.0.conv1.weight"])
    assert torch.equal(model.fc1.weight, _tsm(seed=4).fc1.weight)


@pytest.mark.parametrize("key", ["stem.0.weight", "s1.pathway0_stem.conv.weight"],
                         ids=["video-resnet", "slowfast"])
def test_later_families_raise_naming_their_item(tmp_path, key):
    """A FAIR SlowFast pickle and a torchvision video-ResNet pickle (BN
    running statistics, a Kinetics head) import onto their templates as the
    JAX package's importers do."""
    path = str(tmp_path / "other.pth")
    if key.startswith("stem"):
        sd = {key: torch.arange(6.0).reshape(2, 3, 1, 1, 1), "stem.1.weight": torch.ones(2),
              "stem.1.bias": torch.full((2,), 0.5), "stem.1.running_mean": torch.zeros(2),
              "stem.1.running_var": torch.ones(2), "stem.1.num_batches_tracked": torch.tensor(3),
              "fc.weight": torch.ones(400, 2), "fc.bias": torch.ones(400)}
        torch.save(sd, path)
        template = {"stem": {"kernel": np.zeros((1, 1, 1, 3, 2), np.float32),
                             "bn_scale": np.zeros(2, np.float32),
                             "bn_bias": np.zeros(2, np.float32)},
                    "fc_kernel": np.zeros((2, 1), np.float32), "fc_bias": np.zeros(1, np.float32)}
        got = tckpt.load_params(path, template=template)
        want = JI.import_video_resnet_state_dict(torch.load(path), template)
        _assert_trees_equal(got, want)
        np.testing.assert_array_equal(got["stem"]["kernel"][0, 0, 0], sd[key][:, :, 0, 0, 0].numpy().T)
        assert not got["fc_kernel"].any()  # the Kinetics head is skipped
        return
    sd = {key: torch.arange(6.0).reshape(2, 3, 1, 1, 1),
          "s1.pathway0_stem.bn.weight": torch.ones(2),
          "s1.pathway0_stem.bn.bias": torch.full((2,), 0.5),
          "s1.pathway0_stem.bn.running_mean": torch.zeros(2),
          "s1.pathway0_stem.bn.num_batches_tracked": torch.tensor(3),
          "head.projection.weight": torch.ones(400, 2), "head.projection.bias": torch.ones(400)}
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    template = {"slow_stem": {"kernel": np.zeros((1, 1, 1, 3, 2), np.float32),
                              "bn_scale": np.zeros(2, np.float32),
                              "bn_bias": np.zeros(2, np.float32)},
                "head_kernel": np.zeros((2, 1), np.float32), "head_bias": np.zeros(1, np.float32)}
    got = tckpt.load_params(path, template=template)
    want = JI.import_slowfast_state_dict(torch.load(path), template)
    _assert_trees_equal(got, want)
    np.testing.assert_array_equal(got["slow_stem"]["kernel"][0, 0, 0],
                                  sd[key][:, :, 0, 0, 0].numpy().T)
    assert not got["head_kernel"].any()  # the Kinetics head is skipped


# ------------------------- meters, grad tools, ES ---------------------------

def test_average_meter_matches_jax():
    ours, theirs = TMeter(), JMeter()
    for v, n in ((0.5, 1), (np.float32(1.25), 3), (2, 2)):
        ours.update(v, n)
        theirs.update(v, n)
    assert vars(ours) == vars(theirs)


def test_gradtools_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    grads = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
             for k, v in _int().state_dict().items()}
    jgrads = to_jax_params(grads)
    np.testing.assert_allclose(float(tgrad.global_grad_norm(grads)),
                               float(jgrad.global_grad_norm(jgrads)), rtol=1e-6)
    for do in (False, True):
        ours, norm = tgrad.clip_grad_norm(grads, 1.0, do=do)
        theirs, jnorm = jgrad.clip_grad_norm(jgrads, 1.0, do=do)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        got = to_jax_params(ours)
        for k in theirs:
            np.testing.assert_allclose(got[k], np.asarray(theirs[k]), rtol=1e-6, atol=1e-7)
    rows, jrows = tgrad.grad_flow_stats(grads), jgrad.grad_flow_stats(jgrads)
    assert [r[0] for r in rows] == [r[0] for r in jrows]
    np.testing.assert_allclose([r[1:] for r in rows], [r[1:] for r in jrows], rtol=1e-6)
    path = str(tmp_path / "flow.png")
    assert tgrad.plot_grad_flow(grads, path) == rows and os.path.getsize(path) > 0


def test_early_stopping_matches_jax(tmp_path):
    accs = [50.0, 61.2, 61.2, 60.0, 58.0, 70.9, 69.0, 65.0, 64.0]
    state = _int().state_dict()
    seen = {}
    for name, cls in (("torch", TEarlyStopping), ("jax", JEarlyStopping)):
        lines = []
        es = cls(patience=3, results_folder=str(tmp_path / name), trace_func=lines.append)
        trace = []
        for epoch, acc in enumerate(accs):
            es(acc, state if name == "torch" else to_jax_params(state), epoch)
            trace.append((es.counter, es.early_stop, es.best_score))
        seen[name] = (trace, lines, sorted(os.listdir(tmp_path / name / "saved_models")))
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0][-1][1] and seen["torch"][2][0].startswith("model_val_acc_0050_epoch_00")


# ------------------------- optimizer state, both ways -----------------------

FLAGS = {"none": {}, "clip": {"clip_grad": 1.0}, "accum": {"accum_steps": 2},
         "ema": {"ema": 0.9}, "schedule": {"schedule": "cosine"}}


def _optimizers(flags):
    kw = dict(FLAGS[flags])
    if kw.pop("schedule", None):
        jkw = dict(kw, schedule=J.build_lr_schedule("cosine", 1e-3, 2, 2))
        tkw = dict(kw, schedule=T.build_lr_schedule("cosine", 1e-3, 2, 2))
        return J.make_optimizer(1e-3, **jkw), T.make_optimizer(1e-3, **tkw)
    return J.make_optimizer(1e-3, **kw), T.make_optimizer(1e-3, **kw)


@functools.cache
def _three_steps(flags):
    """The same 3 gradients through optax and the port's Optimizer, once a
    flag set: (names, optax transform, optax state, port Optimizer)."""
    model = _int()
    names = [n for n, _ in model.named_parameters()]
    params = to_jax_params(model.state_dict())
    jtx, topt = _optimizers(flags)
    state = jtx.init(params)
    topt.init(list(model.parameters()))
    update = jax.jit(jtx.update)  # one compile costs less than op-by-op dispatch
    rng = np.random.default_rng(0)
    for _ in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        updates, state = update(g, state, params)
        params = optax.apply_updates(params, updates)
        sd = state_dict_from_jax("InT", g)
        topt.step([sd[n] for n in names])
    return names, jtx, state, topt


def _assert_state_close(got, want, path="opt_state"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got.keys(), want.keys())
        for k in want:
            _assert_state_close(got[k], want[k], f"{path}/{k}")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9, err_msg=path)


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_optimizer_state_is_the_optax_tree_both_ways(flags):
    names, jtx, state, topt = _three_steps(flags)
    want = serialization.to_state_dict(jax.device_get(state))
    got = topt.state_dict(names)
    _assert_state_close(got, want)
    # Through the checkpoint bytes, into optax.
    restored = serialization.from_state_dict(
        jtx.init(to_jax_params(_int().state_dict())),
        tckpt.unpackb(tckpt.packb({"opt_state": got}))["opt_state"])
    _assert_state_close(serialization.to_state_dict(restored), want)
    # And JAX's tree into a fresh port optimizer.
    model = _int(seed=7)
    _, fresh = _optimizers(flags)
    fresh.init(list(model.parameters()))
    fresh.load_state_dict(serialization.msgpack_restore(
        serialization.msgpack_serialize(want)), names, "InT")
    _assert_state_close(fresh.state_dict(names), want)
    assert fresh.count == topt.count and fresh.mini_step == topt.mini_step


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_optimizer_state_of_other_flags_raises(flags):
    names, _, state, _ = _three_steps(flags)
    tree = serialization.to_state_dict(jax.device_get(state))
    for other in sorted(set(FLAGS) - {flags}):
        model = _int()
        _, opt = _optimizers(other)
        opt.init(list(model.parameters()))
        before = [t.clone() for t in opt.mu]
        with pytest.raises((ValueError, KeyError, TypeError)):
            opt.load_state_dict(tree, names, "InT")
        assert all(torch.equal(a, b) for a, b in zip(before, opt.mu)) and opt.count == 0


def test_optimizer_state_of_other_shapes_raises():
    names, _, state, _ = _three_steps("none")
    tree = serialization.to_state_dict(jax.device_get(state))
    wide = InT(dimensions=DIMS + 1, timesteps=T_STEPS, kernel_size=K, device="cpu")
    opt = T.make_optimizer(1e-3).init(list(wide.parameters()))
    with pytest.raises(ValueError, match="shape"):
        opt.load_state_dict(tree, names, "InT")


def test_rntsm_optimizer_state_is_nested_like_its_params():
    model = _tsm()
    names = [n for n, _ in model.named_parameters()]
    opt = T.make_optimizer(1e-3, ema=0.5).init(list(model.parameters()))
    opt.step([torch.ones_like(p) for p in model.parameters()])
    tree = opt.state_dict(names)
    jparams = _tsm_template()
    jtx = J.make_optimizer(1e-3, ema=0.5)
    shapes = jax.eval_shape(jtx.init, jparams)
    restored = serialization.from_state_dict(shapes, tree)
    assert jax.tree.structure(restored) == jax.tree.structure(shapes)
    again = T.make_optimizer(1e-3, ema=0.5).init(list(_tsm(seed=1).parameters()))
    again.load_state_dict(tree, names, "rntsm")
    for a, b in zip(again.mu + again.ema, opt.mu + opt.ema):
        assert torch.equal(a, b)

