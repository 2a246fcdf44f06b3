"""The port's data-parallel training (pathtracker_torch/parallel/) against
one process and against the JAX package's single-device steps.

Two gloo ranks (tests/torch_parallel_worker.py, torch on one thread, no JAX
and no conftest) meet through a file store under the test's tmp folder and
run every case once, beside a world of one; the references run here, JAX
jitted. The ranks split each global batch in rank order.

Tolerances:
- BatchNorm statistics, their gradients and the Jacobian penalty's double
  backward, all in f64 (the statistics widened from their f32 by the
  worker): 1e-10 against one process on the concatenated rows.
- The InT train step against JAX's single-device ``make_train_step`` on the
  global batch: the tolerances tests/test_parallel.py:57-99 holds JAX's own
  sharded step to, loss rtol 1e-5 and weights atol 2e-5 in f32 (the eager
  cell), 1e-4 and 5e-4 in bf16 (the fused cell: the plain K1-K3 versions
  here). Adam's first update is lr*g/(|g|+eps), sign-like, so an entry
  whose gradient sits at rounding distance from zero may move by up to lr
  either way in either package (tests/test_torch_steps.py): the weights are
  held at those tolerances where JAX's gradient clears CUT of its
  parameter's largest, with at most FLIPS entries of a parameter past them,
  and within 2*lr everywhere.
- Meters from counts: exactly the single process's.
- The resident step over 2 ranks against JAX's over a 2-device mesh:
  gathered clips bit-equal, losses and weights as the f32 step.
- A world of one against no group: bit-equal.
"""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracker_torch.ops import int_fused as TF
from pathtracker_torch.ops.layers import batch_norm as tbatch_norm
from pathtracker_torch.ops.penalty import jacobian_penalty
from pathtracker_torch.train.torch_import import export_reference_state_dict, to_jax_params
from pathtracker_torch.utils.metrics import acc_scores as tacc_scores
from pathtracker_tpu.data import resident as JR
from pathtracker_tpu.models.int_circuit import InT as JInT
from pathtracker_tpu.parallel import mesh as jmesh
from pathtracker_tpu.train import steps as J
from pathtracker_tpu.utils.metrics import acc_scores as jacc_scores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
sys.path.insert(0, os.path.dirname(WORKER))
import torch_parallel_worker as worker  # noqa: E402
LR, CUT, FLIPS = 1e-3, 1e-2, 2
B, TS, HW, K = 8, 4, 16, 3  # global batch, timesteps, side, kernel
TOL = {"float32": (1e-5, 2e-5), "bfloat16": (1e-4, 5e-4)}
MODELS = {"float32": dict(dimensions=8, timesteps=TS, kernel_size=K),
          "bfloat16": dict(dimensions=32, timesteps=TS, kernel_size=K, dtype="bfloat16")}
N_RESIDENT, B_RESIDENT = 16, 8


def _run_ranks(tmp_path, world: int, cases: dict, tag: str, timeout: float = 240):
    """``world`` worker processes on ``cases``; their logs go to files (a
    pipe that fills stalls a rank inside a collective), survivors are killed
    at the timeout. Returns each rank's results."""
    folder = tmp_path / tag
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


def _collect(started, timeout: float = 240):
    procs, logs, folder = started
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


def _init(dtype: str, seed: int = 0):
    jm = JInT(**MODELS[dtype], **({} if dtype == "float32" else {"fused": True}))
    params = jm.init(jax.random.key(seed), jnp.zeros((B, 3, TS, HW, HW)))["params"]
    params = jax.tree.map(np.asarray, params)
    # Non-trivial BN scales and biases, so their gradients are not all alike.
    rng = np.random.default_rng(seed + 7)
    for name, v in params.items():
        if "bn" in name and v.ndim == 1:
            params[name] = (v + rng.normal(0, 0.2, v.shape)).astype(v.dtype)
    state = {k: torch.from_numpy(np.array(v))
             for k, v in export_reference_state_dict(params).items()}
    return jm, params, state


def _batches(seed: int, n: int, size: int = B):
    rng = np.random.default_rng(seed)
    clips = rng.integers(0, 255, size=(n, size, TS, HW, HW, 3), dtype=np.uint8)
    labels = rng.integers(0, 2, size=(n, size), dtype=np.uint8)
    return clips, labels


def _resident_data():
    clips, labels = _batches(5, 1, N_RESIDENT)
    clips, labels = clips[0], labels[0]
    clips[:, 0, 0, 0, 0] = np.arange(N_RESIDENT)  # a clip's own index
    return clips, labels


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on two ranks and on a world of one, the workers started
    together."""
    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(3)
    f64 = lambda *shape: torch.from_numpy(rng.standard_normal(shape))  # noqa: E731
    clips, labels = _batches(1, 1)
    cases = {
        "bn": dict(kind="bn", x=f64(24, 5) * 2 + 1, y=f64(4, 3, 3, 5) + 0.5,
                   scale=f64(5), bias=f64(5), gm=f64(5), gr=f64(5), gy=f64(4, 3, 3, 5)),
        "penalty": dict(kind="penalty", h=f64(8, 6), w=f64(6, 6) * 0.5, scale=f64(6),
                        bias=f64(6)),
        # Rank 0's half: 3 of 4 predicted positive, 1 of them right; rank 1's:
        # 1 predicted, right (precision 1/3 and 1; the batch's 2/4).
        "meters": dict(kind="meters", target=torch.tensor([1., 0, 0, 1, 1, 0, 1, 0]),
                       logits=torch.tensor([0.9, 2.0, 1.0, -1.0, 3.0, -2.0, 0.2, 0.1])),
    }
    for dtype in MODELS:
        for penalty in (False, True) if dtype == "float32" else (False,):
            cases[f"step-{dtype}-{penalty}"] = dict(
                kind="step", model=MODELS[dtype], state=_init(dtype)[2], lr=LR,
                penalty=penalty, clips=torch.from_numpy(clips), labels=torch.from_numpy(labels))
    rclips, rlabels = _resident_data()
    resident = dict(kind="resident", model=MODELS["float32"], state=_init("float32", 1)[2],
                    lr=LR, clips=torch.from_numpy(rclips), labels=torch.from_numpy(rlabels),
                    batch=B_RESIDENT, seed=0, fused=2, windows=1)
    cases["resident"] = resident
    two = _run_ranks(tmp, 2, cases, "two")
    wclips, wlabels = _batches(2, 2, 4)
    one = _run_ranks(tmp, 1, {
        dtype: dict(kind="world1", model=MODELS[dtype], state=_init(dtype, 2)[2], lr=LR,
                    penalty=False, clips=torch.from_numpy(wclips),
                    labels=torch.from_numpy(wlabels),
                    resident={k: resident[k] for k in ("clips", "labels", "batch", "seed",
                                                       "fused", "windows")})
        for dtype in MODELS}, "one")
    return {"cases": cases, "two": _collect(two), "one": _collect(one)[0]}


def _cat(results, name, key):
    return torch.cat([r[name][key] for r in results])


def _close(got, want, tol=1e-10):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


def test_batch_statistics_and_their_gradients_are_the_global_batchs(runs):
    case, two = runs["cases"]["bn"], runs["two"]
    x = case["x"].clone().requires_grad_()
    y = case["y"].clone().requires_grad_()
    scale, bias = case["scale"].clone().requires_grad_(), case["bias"].clone().requires_grad_()
    with worker.f64_statistics():
        mean, rstd = TF.stats(x)
        dx, = torch.autograd.grad((mean * case["gm"]).sum() + (rstd * case["gr"]).sum(), x)
        out = tbatch_norm(y, scale, bias)
        dy, dscale, dbias = torch.autograd.grad((out * case["gy"]).sum(), (y, scale, bias))
    for r in two:  # every rank holds the global statistics
        _close(r["bn"]["mean"], mean.detach())
        _close(r["bn"]["rstd"], rstd.detach())
    _close(_cat(two, "bn", "dx"), dx)
    _close(_cat(two, "bn", "out"), out.detach())
    _close(_cat(two, "bn", "dy"), dy)
    _close(sum(r["bn"]["dscale"] for r in two), dscale)
    _close(sum(r["bn"]["dbias"] for r in two), dbias)
    # and they are not each rank's own statistics
    half = case["x"][:12]
    assert not np.allclose(two[0]["bn"]["mean"], half.mean(0), atol=1e-3)


def test_penalty_double_backward_reduces_over_the_ranks(runs):
    """jacobian_penalty calls autograd.grad through a BatchNorm, so the
    all-reduce's backward runs inside it and is differentiated again."""
    case, two = runs["cases"]["penalty"], runs["two"]
    h = case["h"].clone().requires_grad_()
    w, scale, bias = (case[k].clone().requires_grad_() for k in ("w", "scale", "bias"))
    with worker.f64_statistics():
        pen = jacobian_penalty(worker.penalty_step(w, scale, bias), h)
        dh, dw, dscale, dbias = torch.autograd.grad(pen, (h, w, scale, bias))
    assert pen > 0
    _close(sum(r["penalty"]["penalty"] for r in two) / 2, pen.detach())
    _close(_cat(two, "penalty", "dh"), dh)
    for key, want in (("dw", dw), ("dscale", dscale), ("dbias", dbias)):
        _close(sum(r["penalty"][key] for r in two), want)


def test_meters_come_from_the_global_counts(runs):
    case, two = runs["cases"]["meters"], runs["two"]
    want = torch.stack(tacc_scores(case["target"], case["logits"]))
    theirs = np.asarray(jacc_scores(jnp.asarray(case["target"].numpy()),
                                    jnp.asarray(case["logits"].numpy())))
    for r in two:
        assert torch.equal(r["meters"]["global"], want)
    np.testing.assert_allclose(want.numpy(), theirs, rtol=1e-6)
    mean_of_ranks = (two[0]["meters"]["local"] + two[1]["meters"]["local"]) / 2
    assert two[0]["meters"]["local"][1] != two[1]["meters"]["local"][1]  # precisions differ
    assert not np.isclose(float(mean_of_ranks[1]), float(want[1]))  # precision
    assert not np.isclose(float(mean_of_ranks[3]), float(want[3]))  # f1


def _jax_step(dtype, penalty, clips, labels):
    jm, params, _ = _init(dtype)
    step = J.make_train_step(jm, "InT", J.make_optimizer(LR), penalty=penalty)
    params, state, stats = step(params, J.make_optimizer(LR).init(params), jnp.asarray(clips),
                                jnp.asarray(labels))
    return jax.tree.map(np.asarray, params), stats, _rms_gradients(state)


def _rms_gradients(opt_state):
    """sqrt(nu), Adam's RMS gradient, from the JAX run's optimizer state."""
    return {k: np.sqrt(np.asarray(v)) for k, v in opt_state[0].nu.items()}


def _hold_weights(state, want: dict, grads: dict, atol: float, steps: int = 1):
    """The weights after Adam steps against JAX's, by the module's rule
    (``grads``: the size of JAX's gradients, entry by entry)."""
    ours = to_jax_params(state)
    held = 0
    for name, w in want.items():
        diff = np.abs(ours[name] - w)
        assert diff.max() <= 2 * LR * steps, (name, diff.max())
        g = grads[name]
        clear = g > CUT * max(g.max(), 1e-30)
        assert np.sum(clear & (diff > atol)) <= FLIPS, (name, np.sort(diff[clear])[-4:])
        held += int(clear.sum())
    assert held > sum(v.size for v in want.values()) // 2


@pytest.mark.parametrize("dtype,penalty", [("float32", False), ("float32", True),
                                           ("bfloat16", False)])
def test_two_rank_step_matches_jax_on_the_global_batch(runs, dtype, penalty):
    case, two = runs["cases"][f"step-{dtype}-{penalty}"], runs["two"]
    rtol, atol = TOL[dtype]
    clips, labels = case["clips"][0].numpy(), case["labels"][0].numpy()
    want, stats, grads = _jax_step(dtype, penalty, clips, labels)
    got = [r[f"step-{dtype}-{penalty}"] for r in two]
    # Both ranks log the global scalars and end with the same weights.
    assert torch.equal(got[0]["stats"], got[1]["stats"])
    for k, v in got[0]["state"].items():
        assert torch.equal(v, got[1]["state"][k]), k
    np.testing.assert_allclose(float(got[0]["stats"][0, 0]), float(stats["loss"]), rtol=rtol)
    np.testing.assert_allclose(got[0]["stats"][0, 3:].numpy(),
                               np.asarray([stats[k] for k in
                                           ("balacc", "precision", "recall", "f1score")]),
                               rtol=1e-6)
    if penalty:  # InT's penalty is ones(1), as JAX's: the scaled loss carries 10
        np.testing.assert_allclose(float(got[0]["stats"][0, 1]), float(stats["scaled_loss"]),
                                   rtol=rtol)
    _hold_weights(got[0]["state"], want, grads, atol)
    # bf16 runs the fused cell (the K1-K3 wrappers' plain versions here)
    assert bool(got[0]["fused"]) == (dtype == "bfloat16")


def test_chip_smoke_witness_computes_the_bf16_step_as_the_two_ranks(runs):
    """chip_smoke.py's phase 13 (h1) holds the ranks' bf16 step against one
    process that computes the global batch as the ranks do
    (``chip_smoke._as_ranks``). With the plain K1-K3 versions, on one
    thread as the workers run, that process logs the ranks' loss bit for
    bit and ends at their weights within test_parallel's bf16 atol, every
    entry (its gradients differ from the ranks' only in the order of the
    f32 sums over time steps and ranks)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    from pathtracker_torch.models.int_circuit import InT
    from pathtracker_torch.train.steps import make_optimizer, make_train_step

    name = "step-bfloat16-False"
    case, ranks = runs["cases"][name], runs["two"][0][name]
    model = InT(device="cpu", **case["model"])
    model.load_state_dict(case["state"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with chip_smoke._as_ranks(2):
            stats = make_train_step(model, "InT", make_optimizer(case["lr"]))(
                case["clips"][0], case["labels"][0])
    finally:
        torch.set_num_threads(threads)
    assert float(stats["loss"]) == float(ranks["stats"][0, 0])
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ranks["state"][k].numpy(), rtol=0,
                                   atol=TOL["bfloat16"][1], err_msg=k)


def test_two_rank_resident_step_gathers_and_trains_as_jax_over_a_mesh(runs):
    case, two = runs["cases"]["resident"], runs["two"]
    clips, labels = case["clips"].numpy(), case["labels"].numpy()
    jm, params, _ = _init("float32", 1)
    mesh = jmesh.make_mesh(2)
    opt = J.make_optimizer(LR)
    step = JR.make_resident_train_step(jm, "InT", opt, n_clips=N_RESIDENT,
                                       batch_size=B_RESIDENT, seed=0, mesh=mesh,
                                       fused_steps=2)
    sh = jmesh.batch_sharding(mesh)
    jparams, jstate, stats = step(jmesh.replicate_tree(mesh, params),
                                  jmesh.replicate_tree(mesh, opt.init(params)),
                                  jax.device_put(clips, sh), jax.device_put(labels, sh))
    n_local, b_local = N_RESIDENT // 2, B_RESIDENT // 2
    for rank, r in enumerate(two):
        got = r["resident"]
        for s in range(2):
            key = jax.random.fold_in(jax.random.fold_in(jax.random.key(0), np.uint32(0)), rank)
            perm = np.asarray(jax.random.permutation(key, n_local))
            want = perm[(s * b_local + np.arange(b_local)) % n_local]
            np.testing.assert_array_equal(got["indices"][s].numpy(), want)
            # the clips it gathered, by their own index, from its slice
            np.testing.assert_array_equal(got["gathered"][s].numpy(), want + rank * n_local)
        np.testing.assert_allclose(got["loss"].numpy(), np.asarray(stats["loss"]),
                                   rtol=TOL["float32"][0])
    _hold_weights(two[0]["resident"]["state"], jax.tree.map(np.asarray, jparams),
                  _rms_gradients(jstate), TOL["float32"][1], steps=2)


@pytest.mark.parametrize("dtype", list(MODELS))
def test_a_world_of_one_is_bit_identical_to_no_group(runs, dtype):
    got = runs["one"][dtype]
    for path in ("step", "resident"):
        a, b = got["group"][path], got["none"][path]
        for key in a:
            if key == "seconds":
                continue
            if key == "state":
                for k in a[key]:
                    assert torch.equal(a[key][k], b[key][k]), (path, k)
            else:
                assert torch.equal(a[key], b[key]), (path, key)


