"""The port's model-parallel modes (pathtracker_torch/parallel/) against the
JAX package's single-device functions.

The ranks are processes of tests/torch_model_parallel_worker.py (torch only,
one thread, gloo over a file store under the test's tmp folder): one world
of 2, one of 4 and one of 1, started together with the dry-run CLI at 4 CPU
ranks, once for the module; the references run here meanwhile, JAX jitted.
JAX's own tests pin its sharded paths to these single-device references.

Tolerances:
- The sharding rules: the port's placements equal JAX's fsdp_shardings,
  channel_shardings and hybrid_shardings on the same trees, JAX's dims
  mapped to torch's by each parameter's layout (HWIO -> OIHW, [I,O] -> a
  1x1 conv's [O,I,1,1] or a Linear's [O,I], [C] -> [C,1,1]).
- InT steps against ``make_train_step``: as tests/test_torch_parallel.py,
  loss rtol 1e-5 and weights atol 2e-5 in f32 (the eager cell), 1e-4 and
  5e-4 in bf16 (the fused cell, the plain K1-K3 versions here), the
  weights under that file's Adam-flip rule (held where JAX's gradient
  clears CUT of its parameter's largest, at most FLIPS entries past the
  atol, every entry within 2*lr).
- rntsm under FSDP, one SGD step at 1e-2 (the update is the gradient), in
  float64 in both packages (BN statistics widened to f64 by the test, the
  port's correlation its plain version): f32 ResNet gradients are chaotic at
  test shapes (tests/test_torch_tsm_steps.py: a ReLU input within rounding
  of zero moves a normalised gradient by percents; on this batch at 12x12
  JAX's f32 gradient of flow_refinement's dw1 BN was 2.2% from the f64 one
  on average, the port's f32 0.2%). The update over lr against
  ``jax.grad`` by test_torch_tsm_steps.py's rule, normalised by the
  parameter's largest entry: within 0.1 but for R_FLIPS entries, the mean
  within 2e-2 (the two f64 forwards still differ by ~3e-8 relative, enough
  to flip a mask).
- The pipeline against the stages run in turn: forward atol 1e-6 on a
  4 x 1 mesh, 1e-5 on 2 x 2; gradients rtol 1e-4 / atol 1e-4.
- MoE over 4 ranks against ``moe_apply``: forward and gradients atol 1e-5.
- A world of one against no group: bit-equal.
"""

import functools
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracker_torch.models.int_circuit import InT as TInT
from pathtracker_torch.models.tsm_resnet import TSMResNet as TTSM
from pathtracker_torch.parallel import mesh as M
from pathtracker_torch.train.torch_import import jax_leaves, state_dict_from_jax, to_jax_params
from pathtracker_tpu.models.int_circuit import InT as JInT
from pathtracker_tpu.models.tsm_resnet import TSMResNet as JTSM
from pathtracker_tpu.parallel import mesh as jmesh
from pathtracker_tpu.parallel import moe as jmoe
from pathtracker_tpu.parallel import pipeline as jpipe
from pathtracker_tpu.train import steps as J

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_model_parallel_worker.py")
LR, CUT, FLIPS = 1e-3, 1e-2, 2
B, TS, HW, K = 8, 3, 16, 3
TOL = {"float32": (1e-5, 2e-5), "bfloat16": (1e-4, 5e-4)}
MODELS = {"float32": dict(dimensions=8, timesteps=TS, kernel_size=K),
          "bfloat16": dict(dimensions=32, timesteps=TS, kernel_size=K, dtype="bfloat16")}
R_T = 2
RNTSM = dict(layers=(1, 1, 1, 1), num_segments=R_T, patch=5)
R_B, R_HW, R_LR, R_FLIPS = 2, 8, 1e-2, 2
WIDTH = 8
N_EXPERTS, D_IN, D_HID = 8, 16, 32


@functools.lru_cache(maxsize=None)
def _int(dtype: str):
    """The port's InT weights (BN scales and biases randomised, so their
    gradients differ), JAX's module and the same weights as JAX params."""
    jm = JInT(**MODELS[dtype], **({} if dtype == "float32" else {"fused": True}))
    state = TInT(device="cpu", seed=2, **MODELS[dtype]).state_dict()
    rng = np.random.default_rng(7)
    for name, v in state.items():
        if ".bn." in name:
            state[name] = v + torch.from_numpy(rng.normal(0, 0.2, v.shape).astype(np.float32))
    return jm, to_jax_params(state), state


def _batch(seed, n, t, hw):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, size=(n, t, hw, hw, 3), dtype=np.uint8),
            rng.integers(0, 2, size=(n,), dtype=np.uint8))


@functools.lru_cache(maxsize=None)
def _jax_int_step(dtype: str):
    jm, params, _ = _int(dtype)
    clips, labels = _batch(1, B, TS, HW)
    opt = J.make_optimizer(LR)
    step = J.make_train_step(jm, "InT", opt)
    new, state, stats = step(jax.tree.map(jnp.array, params), opt.init(params),
                             jnp.asarray(clips), jnp.asarray(labels))
    rms = {k: np.sqrt(np.asarray(v)) for k, v in state[0].nu.items()}
    return jax.tree.map(np.asarray, new), {k: float(v) for k, v in stats.items()}, rms


@functools.lru_cache(maxsize=None)
def _rntsm():
    state = TTSM(device="cpu", **RNTSM).state_dict()
    return JTSM(**RNTSM), to_jax_params(state), state


def _stage_params(n_stages: int):
    """tests/test_parallel.py's conv trunk of ``n_stages`` stages, HWIO."""
    rng = np.random.default_rng(0)
    return [{"k": rng.normal(0, 0.2, (3, 3, WIDTH, WIDTH)).astype(np.float32),
             "b": rng.normal(0, 0.1, (WIDTH,)).astype(np.float32)} for _ in range(n_stages)]


def _stacked(n_stages: int) -> dict:
    """JAX's stacked stages carried into the port (HWIO -> OIHW)."""
    return state_dict_from_jax("pipeline", jpipe.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in _stage_params(n_stages)]))


def _pipe_x():
    return np.random.default_rng(1).normal(0, 1, (8, 6, 6, WIDTH)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _moe():
    params = jmoe.init_moe_params(jax.random.key(0), N_EXPERTS, D_IN, D_HID)
    x = jax.random.normal(jax.random.key(1), (16, D_IN))
    return jax.tree.map(np.asarray, params), np.asarray(x)


def _tensor(a):
    return torch.from_numpy(np.array(a))


def _start(tmp, world: int, cases: dict, tag: str):
    folder = tmp / tag
    folder.mkdir()
    torch.save(cases, folder / "in.pt")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs, logs = [], []
    for rank in range(world):
        log = open(folder / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(rank), str(world), str(folder / "store"),
             str(folder / "in.pt"), str(folder / f"out{rank}.pt")],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs, logs, folder


def _wait(procs, logs, folder, timeout: float = 300):
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    for rank, p in enumerate(procs):
        text = (folder / f"rank{rank}.log").read_text()
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{text[-4000:]}"
    return [torch.load(folder / f"out{rank}.pt") for rank in range(len(procs))]


def _step_case(dtype, mode, mesh):
    clips, labels = _batch(1, B, TS, HW)
    return dict(kind="step", model="InT", kwargs=MODELS[dtype], state=_int(dtype)[2], lr=LR,
                mode=mode, mesh=mesh, clips=_tensor(clips), labels=_tensor(labels))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on its world, the worlds and the dry run started
    together, the JAX references computed while they run."""
    tmp = tmp_path_factory.mktemp("model_parallel")
    rclips, rlabels = _batch(3, R_B, R_T, R_HW)
    two = {"fsdp2": _step_case("float32", "fsdp", (2,)),
           "tp-bf16": _step_case("bfloat16", "tp", (1, 2)),
           "sp-bf16": _step_case("bfloat16", "sp", (1, 2)),
           "rntsm": dict(kind="step", model="rntsm", kwargs=RNTSM, state=_rntsm()[2],
                         lr=R_LR, sgd=True, f64=True, mode="fsdp", mesh=(2,),
                         clips=_tensor(rclips),
                         labels=_tensor(rlabels))}
    params, x = _moe()
    four = {"fsdp4": _step_case("float32", "fsdp", (4,)),
            **{mode: _step_case("float32", mode, (2, 2)) for mode in ("tp", "hybrid", "sp")},
            **{f"pipe{s}{d}": dict(kind="pipeline", mesh=(s, d), stacked=_stacked(s),
                                   x=_tensor(_pipe_x())) for s, d in ((4, 1), (2, 2))},
            "ep": dict(kind="moe", mesh=(4,), params=state_dict_from_jax("moe", params),
                       x=_tensor(x)),
            "dpep": dict(kind="moe", mesh=(2, 2), params=state_dict_from_jax("moe", params),
                         x=_tensor(x))}
    wclips, wlabels = _batch(5, 4, TS, HW)
    one = {dtype: dict(kind="world1", model="InT", kwargs=MODELS[dtype], state=_int(dtype)[2],
                       lr=LR, clips=_tensor(wclips), labels=_tensor(wlabels))
           for dtype in MODELS}
    started = {"two": _start(tmp, 2, two, "two"), "four": _start(tmp, 4, four, "four"),
               "one": _start(tmp, 1, one, "one")}
    dry_log = open(tmp / "dryrun.log", "w")
    dry = subprocess.Popen([sys.executable, "-m", "pathtracker_torch.parallel.dryrun",
                            "--ranks", "4", "--device", "cpu"], cwd=ROOT,
                           env={**os.environ, "OMP_NUM_THREADS": "1"}, stdout=dry_log,
                           stderr=subprocess.STDOUT)
    try:
        _jax_rntsm_grads()
        for dtype in MODELS:
            _jax_int_step(dtype)
        _jax_moe_grads()
        out = {name: _wait(*s) for name, s in started.items()}
        dry.wait(timeout=300)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
        dry_log.close()
    out["dryrun"] = (dry.returncode, (tmp / "dryrun.log").read_text())
    out["cases"] = {**two, **four}
    return out


# ------------------------------ sharding rules -------------------------------

def _jax_dim_to_torch(tshape, jshape):
    """torch dim of each JAX axis, by the layout map of the parameter's kind."""
    if len(tshape) == len(jshape) == 4:
        return [2, 3, 1, 0]  # HWIO -> OIHW
    if len(jshape) == 2 and len(tshape) in (2, 3, 4, 5):
        return [1, 0]  # [I,O] / [in,out] / [C,cls] against [O,I,...]
    return [0] * len(jshape)  # [C] -> [C] or [C,1,1]


def _names(params: dict):
    """{JAX path: port name} through the checkpoint name map."""
    probe = {k: torch.full(tuple(v.shape), float(i)) for i, (k, v) in enumerate(params.items())}
    keys = list(params)
    return {path: keys[int(leaf.reshape(-1)[0])] for path, leaf in
            jax_leaves(to_jax_params(probe))}


@functools.lru_cache(maxsize=None)
def _trees():
    """The JAX package's own init of each tree (its shapes), beside the
    port's model."""
    jm, _, _ = _int("float32")
    jparams = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((B, 3, TS, HW, HW)))["params"]
    rm = JTSM(**RNTSM)
    rparams = jax.eval_shape(rm.init, jax.random.key(0),
                             jnp.zeros((R_B, 3, R_T, R_HW, R_HW)))["params"]
    return {"InT": (jparams, dict(TInT(device="cpu", **MODELS["float32"]).named_parameters())),
            "rntsm": (rparams, dict(TTSM(device="cpu", **RNTSM).named_parameters()))}


def _jax_spec_in_torch(spec, tshape, jshape):
    out = [None] * len(tshape)
    dims = _jax_dim_to_torch(tshape, jshape)
    for j, axis in enumerate(tuple(spec) + (None,) * (len(jshape) - len(tuple(spec)))):
        if axis is not None:
            out[dims[j]] = axis
    return tuple(out)


RULES = {"fsdp": lambda jm_, tm_, p, j: (jmesh.fsdp_shardings(jm_, j), M.fsdp_shardings(tm_, p)),
         "channel": lambda jm_, tm_, p, j: (jmesh.channel_shardings(jm_, j),
                                            M.channel_shardings(tm_, p)),
         "hybrid": lambda jm_, tm_, p, j: (jmesh.hybrid_shardings(jm_, j),
                                           M.hybrid_shardings(tm_, p))}


@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("tree", ["InT", "rntsm"])
def test_placements_are_jaxs_rules_mapped_to_torch_layouts(rule, tree):
    from jax.sharding import Mesh

    jparams, tparams = _trees()[tree]
    devices = np.asarray(jax.devices()[:4])
    meshes = {"fsdp": [(Mesh(devices[:n], ("data",)), SimpleNamespace(shape={"data": n}))
                       for n in (2, 4)],
              "channel": [(Mesh(devices.reshape(2, 2), ("data", "model")),
                           SimpleNamespace(shape={"data": 2, "model": 2}))],
              "hybrid": [(Mesh(devices.reshape(2, 2), ("data", "model")),
                          SimpleNamespace(shape={"data": 2, "model": 2}))]}[rule]
    names = _names(tparams)
    for jm_, tm_ in meshes:
        jspecs, tspecs = RULES[rule](jm_, tm_, tparams, jparams)
        assert set(tspecs) == set(tparams)
        split = 0
        for path, sharding in jax.tree_util.tree_leaves_with_path(jspecs):
            key = names[jax.tree_util.keystr(path)]
            jshape = np.shape(_leaf(jparams, path))
            want = _jax_spec_in_torch(sharding.spec, tuple(tparams[key].shape), jshape)
            assert tspecs[key] == want, (key, tspecs[key], want, sharding.spec)
            split += any(want)
        assert split > 0


def _leaf(tree, path):
    for part in path:
        tree = tree[part.key]
    return tree


def test_fsdp_rule_cases_of_the_jax_package():
    """tests/test_parallel.py::test_fsdp_sharding_rule's four leaves, as
    port parameters of the same JAX shapes, on a data axis of 8."""
    mesh = SimpleNamespace(shape={"data": 8})
    params = {"unit1.w_exc": (32, 8, 3, 3),  # JAX [3,3,8,32]: the last dim, O
              "unit1.bn.0.weight": (8,),  # divisible, size 8
              "readout_dense.bias": (1,),  # tiny: replicated
              "readout_dense.weight": (7, 5)}  # JAX [5,7]: nothing divides
    specs = M.fsdp_shardings(mesh, params)
    assert specs == {"unit1.w_exc": ("data", None, None, None), "unit1.bn.0.weight": ("data",),
                     "readout_dense.bias": (None,), "readout_dense.weight": (None, None)}
    # and JAX's [3,3,64,64] shards its input channels: torch's dim 1
    assert M.fsdp_shardings(mesh, {"unit1.w_inh": (64, 64, 3, 3)})["unit1.w_inh"] == (
        None, "data", None, None)


# ------------------------------- InT steps -----------------------------------

def _hold_weights(ours: dict, want: dict, rms: dict, atol: float):
    """The weights after one Adam step against JAX's, by the Adam-flip rule
    (``rms``: JAX's RMS gradient, entry by entry)."""
    ours = to_jax_params(ours)
    held = 0
    for name, w in want.items():
        diff = np.abs(ours[name] - w)
        assert diff.max() <= 2 * LR, (name, diff.max())
        g = rms[name]
        clear = g > CUT * max(g.max(), 1e-30)
        assert np.sum(clear & (diff > atol)) <= FLIPS, (name, np.sort(diff[clear])[-4:])
        held += int(clear.sum())
    assert held > sum(v.size for v in want.values()) // 2


def _all_ranks(results, name):
    return [r[name] for r in results]


def _hold_step(runs, world, name, dtype):
    got = _all_ranks(runs[world], name)
    want, stats, rms = _jax_int_step(dtype)
    rtol, atol = TOL[dtype]
    for r in got:  # every rank logs the global scalars and gathers the same weights
        assert torch.equal(r["stats"], got[0]["stats"])
        for k, v in r["state"].items():
            assert torch.equal(v, got[0]["state"][k]), k
        assert r["empty"]  # the module holds no weights between steps
    np.testing.assert_allclose(float(got[0]["stats"][0]), stats["loss"], rtol=rtol)
    _hold_weights(got[0]["state"], want, rms, atol)
    return got


@pytest.mark.parametrize("world,name", [("two", "fsdp2"), ("four", "fsdp4")])
def test_fsdp_step_matches_jax_and_stays_sharded(runs, world, name):
    got = _hold_step(runs, world, name, "float32")
    n = len(got)
    r = got[0]
    shapes = dict(zip(r["names"], r["shards"]))
    sharded = 0
    for key, spec in r["specs"].items():
        full = tuple(r["state"][key].shape)
        want = tuple(d // n if a == "data" else d for d, a in zip(full, spec))
        assert shapes[key] == want, (key, shapes[key], full, spec)
        sharded += "data" in spec
    assert sharded >= len(r["specs"]) // 2
    assert r["moments"] == r["shards"]  # Adam's moments sharded as the parameters
    assert r["count"] == 1  # and its count a replicated host int
    # autograd.grad over the gathered weights: one None only, InT's unread
    # `unit1.w` (JAX's gradient of it is zero), and no other all-zero one
    assert r["none"] == 1 and r["zero"] == 0
    assert [s for s in r["shard_grads"] if s is not None] == [
        s for k, s in zip(r["names"], r["shards"]) if k != "unit1.w"]


@pytest.mark.parametrize("mode", ["tp", "hybrid", "sp"])
def test_2x2_step_matches_jax(runs, mode):
    got = _hold_step(runs, "four", mode, "float32")
    specs = got[0]["specs"]
    if mode == "sp":
        assert not any(any(s) for s in specs.values())
    else:
        assert any("model" in s for s in specs.values())
        if mode == "hybrid":
            assert any("model" in s and "data" in s for s in specs.values())
        # each rank keeps a different block of a split parameter
        key = next(k for k, s in specs.items() if "model" in s)
        full = got[0]["state"][key]
        blocks = {r["shards"][r["names"].index(key)] for r in got}
        assert all(b[0] < full.shape[0] for b in blocks)


@pytest.mark.parametrize("name", ["tp-bf16", "sp-bf16"])
def test_bf16_fused_step_over_two_ranks_matches_jax(runs, name):
    _hold_step(runs, "two", name, "bfloat16")


def test_rntsm_fsdp_shards_layer4_and_matches_jax(runs):
    got = _all_ranks(runs["two"], "rntsm")
    r = got[0]
    wide = {k: s for k, s in r["specs"].items() if k.startswith("layer4.0.") and "conv" in k
            and k.endswith("weight")}
    assert wide and all("data" in s for s in wide.values()), wide
    for other in got[1:]:
        for k, v in other["state"].items():
            assert torch.equal(v, r["state"][k]), k
    assert all(v.dtype == torch.float64 for v in r["state"].values())
    jgrads = _jax_rntsm_grads()
    start = _rntsm()[2]
    update = {k: (start[k].double() - v) / R_LR for k, v in r["state"].items()}
    ours = _f64_tree(update)
    for path, jg in jax.tree_util.tree_leaves_with_path(jgrads):
        name = jax.tree_util.keystr(path)
        jg, tg = np.asarray(jg), _leaf(ours, path)
        gap = np.abs(tg - jg) / np.abs(jg).max()
        assert np.sum(gap > 0.1) <= R_FLIPS, (name, np.sort(gap.ravel())[-R_FLIPS - 1:])
        assert gap.mean() <= 2e-2, (name, gap.mean())


def _f64_tree(state: dict) -> dict:
    """``to_jax_params`` keeping float64 (it converts to f32): each leaf
    split into its f32 part and the f32 rest, mapped, and summed back."""
    hi = {k: v.float() for k, v in state.items()}
    lo = {k: (v - v.float().double()).float() for k, v in state.items()}
    return jax.tree.map(lambda a, b: a.astype(np.float64) + b.astype(np.float64),
                        to_jax_params(hi), to_jax_params(lo))


@functools.lru_cache(maxsize=None)
def _jax_rntsm_grads():
    """``jax.grad`` of the step's loss in float64, the BN statistics of the
    JAX TSM-ResNet widened to f64 (it keeps them in f32 by design)."""
    from pathtracker_tpu import engine as jengine
    from pathtracker_tpu.data.prepare import prepare_batch as jprepare
    from pathtracker_tpu.models import tsm_resnet as JM
    from pathtracker_tpu.utils import metrics as jmetrics

    jm, params, _ = _rntsm()
    clips, labels = _batch(3, R_B, R_T, R_HW)
    jax_bn = JM.batch_norm

    def f64_bn(x, scale, bias, eps=1e-3, axis_name=None):
        axes = tuple(range(x.ndim - 1))
        mean = jnp.mean(x, axes)
        inv = jax.lax.rsqrt(jnp.mean(jnp.square(x), axes) - jnp.square(mean) + eps)
        return (x - mean) * (inv * scale) + bias

    def loss(p):
        imgs, target = jprepare(jnp.asarray(clips), jnp.asarray(labels))
        output, _ = jengine.model_step(jm, {"params": p}, imgs.astype(jnp.float64), "rntsm")
        return jmetrics.bce_with_logits(output, target.astype(jnp.float64))

    JM.batch_norm = f64_bn
    try:
        with jax.enable_x64(True):
            grads = jax.jit(jax.grad(loss))(jax.tree.map(lambda a: a.astype(np.float64),
                                                         params))
            return jax.tree.map(np.asarray, grads)
    finally:
        JM.batch_norm = jax_bn


# --------------------------- pipeline and MoE --------------------------------

def _jax_stage(p, x):
    y = jax.lax.conv_general_dilated(x, p["k"], (1, 1), "SAME",
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return jax.nn.relu(y + p["b"])


@pytest.mark.parametrize("name,atol", [("pipe41", 1e-6), ("pipe22", 1e-5)])
def test_pipeline_matches_the_stages_in_turn(runs, name, atol):
    got = _all_ranks(runs["four"], name)
    n_stages, n_data = (4, 1) if name == "pipe41" else (2, 2)
    stages = [{k: jnp.asarray(v) for k, v in p.items()} for p in _stage_params(n_stages)]
    x = jnp.asarray(_pipe_x())

    def seq(ws, x):
        for p in ws:
            x = _jax_stage(p, x)
        return x

    want = np.asarray(seq(stages, x))
    dws, dx = jax.grad(lambda ws, x: jnp.sum(seq(ws, x) ** 2), argnums=(0, 1))(stages, x)
    data_ranks = got[:n_data]  # stage 0 of each data index: ranks 0 .. n_data-1
    for rank, r in enumerate(got):  # every stage rank holds its rows' outputs and gradients
        mine = got[rank % n_data]
        assert torch.equal(r["y"], mine["y"]) and torch.equal(r["dk"], mine["dk"])
    np.testing.assert_allclose(torch.cat([r["y"] for r in data_ranks]).numpy(), want,
                               rtol=0, atol=atol)
    np.testing.assert_allclose(torch.cat([r["dx"] for r in data_ranks]).numpy(),
                               np.asarray(dx), rtol=1e-4, atol=1e-4)
    ours = to_jax_params({k: sum(r[f"d{k}"] for r in data_ranks) for k in ("k", "b")})
    want = jpipe.stack_stage_params(dws)
    for k in ("k", "b"):
        np.testing.assert_allclose(ours[k], np.asarray(want[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


@functools.lru_cache(maxsize=None)
def _jax_moe_grads():
    """``moe_apply`` and the gradients of mean(y**2), jitted."""
    params, x = _moe()

    def run(p):
        return jax.value_and_grad(lambda q: jnp.mean(jmoe.moe_apply(q, jnp.asarray(x)) ** 2),
                                  has_aux=False)(p)[1], jmoe.moe_apply(p, jnp.asarray(x))

    grads, y = jax.jit(run)({k: jnp.asarray(v) for k, v in params.items()})
    return np.asarray(y), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("name", ["ep", "dpep"])
def test_moe_over_four_ranks_matches_moe_apply(runs, name):
    got = _all_ranks(runs["four"], name)
    want, grads = _jax_moe_grads()
    n_data = 2 if name == "dpep" else 1
    n_expert = 4 // n_data
    rows = [got[d * n_expert] for d in range(n_data)]  # expert rank 0 of each data index
    np.testing.assert_allclose(torch.cat([r["y"] for r in rows]).numpy(), want, rtol=0,
                               atol=1e-5)
    gates = torch.cat([r["gates"] for r in rows]).numpy()
    assert ((gates > 0).sum(axis=1) == 1).all() and (gates.max(axis=1) <= 1).all()
    for r in got:
        np.testing.assert_allclose(r["router_w"].numpy(), np.asarray(grads["router_w"]),
                                   rtol=0, atol=1e-5)
    experts = got[:n_expert]  # data index 0; its expert ranks in order
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(torch.cat([r[k] for r in experts]).numpy(),
                                   np.asarray(grads[k]), rtol=0, atol=1e-5, err_msg=k)


# ------------------------------ dry run, world of one -------------------------

def test_dryrun_cli_runs_every_mode_on_four_cpu_ranks(runs):
    rc, out = runs["dryrun"]
    assert rc == 0, out[-4000:]
    for mode in ("dp step ok", "fsdp step ok", "rntsm fsdp step ok", "dp x tp step ok",
                 "dp x sp step ok", "dp x ep moe step ok", "pp x dp pipeline step ok"):
        assert f"dryrun(4): {mode}" in out, (mode, out[-4000:])


@pytest.mark.parametrize("dtype", list(MODELS))
def test_a_world_of_one_is_bit_identical_to_no_group(runs, dtype):
    got = runs["one"][0][dtype]
    none = got["none"]
    for mode in ("fsdp", "tp", "sp"):
        assert torch.equal(got[mode]["stats"], none["stats"]), mode
        for k, v in none["state"].items():
            assert torch.equal(got[mode]["state"][k], v), (mode, k)


@pytest.mark.parametrize("name", ["tp-bf16", "sp-bf16"])
def test_chip_smoke_witnesses_compute_the_step_as_the_ranks(runs, name):
    """chip_smoke.py's phase 13 (i2) holds the ranks' bf16 step against one
    process computing the batch as the ranks do (``_as_model_ranks``,
    ``_as_space_ranks``). With the plain K1-K3 versions, on one thread as the
    workers run, that process logs the ranks' loss bit for bit and ends at
    their weights within test_parallel's bf16 atol but for FLIPS entries a
    parameter, those within 2*lr (the order of the sums in the backward
    differs: over space the ranks' halo cotangents and weight gradients are
    added after the fact, and Adam's sign-like first update flips an entry
    whose gradient sits at rounding distance from zero)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    from pathtracker_torch.train.steps import make_optimizer, make_train_step

    case, ranks = runs["cases"][name], runs["two"][0][name]
    model = TInT(device="cpu", **case["kwargs"])
    model.load_state_dict(case["state"])
    witness = (chip_smoke._as_model_ranks(2) if name.startswith("tp")
               else chip_smoke._as_space_ranks(2, HW))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with witness:
            stats = make_train_step(model, "InT", make_optimizer(case["lr"]))(
                case["clips"], case["labels"])
    finally:
        torch.set_num_threads(threads)
    assert float(stats["loss"]) == float(ranks["stats"][0])
    for k, v in model.state_dict().items():
        gap = (v - ranks["state"][k]).abs()
        assert gap.max() <= 2 * case["lr"] * (1 + 1e-3), (k, gap.max())
        assert int((gap > TOL["bfloat16"][1]).sum()) <= FLIPS, (k, gap.max())
