"""The port's steps with the canonical chain's stage flags from the JAX
package's own checkpoints (scripts/torch_reproduce_canonical.py's stages):
from its chainA's last chance-plateau checkpoint (epoch 38), its chainA's
last (59) and its chainB, the port's stage-A, stage-B and stage-C steps
are the JAX package's, at full width on rendered clips of each stage (the
plain K1-K3 versions on the CPU, torch on one thread); at stage A's
plateau the port's fused cell steps as the JAX package's default cell,
where the JAX package's opt-in fused cell does not."""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracker_torch import engine as tengine
from pathtracker_torch.data.pathtracker import render_batch
from pathtracker_torch.train import loop as tloop
from pathtracker_torch.train import steps as T
from pathtracker_torch.train.torch_import import to_jax_params
from pathtracker_tpu import engine as jengine
from pathtracker_tpu.train import steps as J
from test_torch_chain import JAX_STARTS, canon
from torch_threads import one_thread  # noqa: F401


STEP_BATCH, STEPS = 2, 2
COS_MIN, NORM_RTOL = 0.75, 0.02
PLATEAU_COS_MIN = 0.99  # the fused cell against JAX's default cell at A's plateau


@pytest.mark.parametrize("tag", ["A", "B", "C"])
def test_stage_steps_from_the_jax_chain_match_jax(tag, tmp_path):
    """From the JAX package's own checkpoint of the stage before, the port's
    steps with the stage's flags (its rate, C's EMA, --bf16: the fused
    cell, plain kernel versions here) are the JAX package's (its eager mixed
    cell), at full width on rendered clips of the stage. On the card the
    same holds for whole stages (PERF.md §6): from the JAX package's
    chainB the port's C lands on either cell. A starts from the JAX chainA's
    last checkpoint on the chance plateau (epoch 38), on the port's eager
    cell, the cell the JAX chain trained on; the fused cell is held there
    at a tighter cosine below.
    Losses at rtol 1e-2 (two clips: a logit's bf16 drift over 64 steps does
    not average out; on the card's 128 the first loss agreed to 2e-4). The
    move of the weights from the start, and of C's EMA, as one vector: its
    length within 2% of JAX's and its cosine with JAX's at least 0.75. A
    first Adam step is lr * sign(gradient), and on two clips a bf16
    rounding flips the sign of many near-zero gradients (measured: cosine
    0.85 at B, 0.97-0.99 at C, lengths within 0.2%); a wrong rate or decay
    moves the length, a wrong gradient the cosine."""
    _steps_match(tag, tmp_path, fused=tag != "A", jax_fused=False)


# A side's window once run, by (side, stage, fused): the tests below hold
# the same windows against each other, so each runs once a module.
_WINDOWS = {}


def _window(tag: str, tmp_path, fused: bool, jax_fused: bool):
    """The port's steps with stage ``tag``'s flags from JAX_STARTS[tag] on
    its fused or eager cell and the JAX package's on its fused or eager
    cell, STEPS batches of the stage's rendered clips: the starting
    weights, the port's steps and JAX's (each a loss and trees)."""
    length, dist, _, _ = canon.STAGES[tag]
    args = tloop.parser.parse_args(canon.stage_flags(tag, canon.knobs({}), str(tmp_path),
                                                     JAX_STARTS[tag]))
    assert args.bf16 and args.model == "InT" and (args.ema is not None) == (tag == "C")
    clips, labels = render_batch(11, STEP_BATCH * STEPS, timesteps=length,
                                 n_distractors=dist, dot_size=2)
    clips = clips.reshape(STEPS, STEP_BATCH, *clips.shape[1:])
    labels = labels.astype(np.uint8).reshape(STEPS, STEP_BATCH)
    port, jax_side = ("port", tag, fused), ("jax", tag, jax_fused)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # JAX's steps run on XLA's threads while the port's run on torch's one.
        jax_run = (None if jax_side in _WINDOWS else
                   pool.submit(_jax_steps, args, length, clips, labels, jax_fused))
        if port not in _WINDOWS:
            _WINDOWS[port] = _port_steps(args, length, clips, labels, fused)
        if jax_run is not None:
            _WINDOWS[jax_side] = jax_run.result()
    start, theirs = _WINDOWS[jax_side]
    return start, _WINDOWS[port], theirs


def _moves(start: dict, mine: dict, theirs: dict) -> dict:
    """For each tree of a step (weights, C's EMA), the move from ``start``
    as one vector, ``mine`` against ``theirs``: (cosine, length ratio)."""
    out = {}
    for what in theirs:
        moved = [np.concatenate([(tree[n] - start[n]).ravel() for n in start])
                 for tree in (mine[what], theirs[what])]
        out[what] = (float(moved[0] @ moved[1] / np.linalg.norm(moved[0])
                           / np.linalg.norm(moved[1])),
                     float(np.linalg.norm(moved[0]) / np.linalg.norm(moved[1])))
    return out


def _steps_match(tag: str, tmp_path, fused: bool, jax_fused: bool,
                 cos_min: float = COS_MIN):
    """The port's window (``_window``) against JAX's at the stage-steps
    tolerances."""
    start, ours, theirs = _window(tag, tmp_path, fused, jax_fused)
    for i, ((loss, mine), (jloss, jtrees)) in enumerate(zip(ours, theirs)):
        np.testing.assert_allclose(loss, jloss, rtol=1e-2, err_msg=f"step {i}")
        assert sorted(mine) == sorted(jtrees)
        for what, (cos, ratio) in _moves(start, mine, jtrees).items():
            assert cos >= cos_min and abs(ratio - 1.0) <= NORM_RTOL, (i, what, cos, ratio)


def _port_steps(args, length: int, clips, labels, fused: bool):
    """The port's steps from ``args.ckpt`` on ``clips`` on its fused cell
    (K1-K3's plain versions here) or its eager mixed cell: each step's
    loss, weights and (with --ema) EMA weights, by JAX param name."""
    tm = tengine.load_ckpt(
        tengine.model_selector(args, length, device="cpu", **({} if fused else {
            "fused": False})), args.ckpt)
    assert tm.use_fused == fused
    topt = T.make_optimizer(args.lr, ema=args.ema)
    tstep = T.make_train_step(tm, "InT", topt)
    names = [n for n, p in tm.named_parameters() if p.requires_grad]
    out = []
    for i in range(len(clips)):
        tstats = tstep(clips[i], labels[i])
        trees = {"weights": to_jax_params(tm.state_dict())}
        if args.ema is not None:
            trees["ema"] = to_jax_params(dict(zip(names, T.ema_params(topt))))
        out.append((tstats["loss"], {w: {n: np.array(v) for n, v in tree.items()}
                                     for w, tree in trees.items()}))
    return out


def _jax_steps(args, length: int, clips, labels, fused: bool = False):
    """The JAX package's steps from ``args.ckpt`` on ``clips`` on its eager
    mixed cell (its default) or its fused one (the Pallas kernels, in
    interpret mode here): the starting weights, and each step's loss,
    weights and (with --ema) EMA weights."""
    jm = jengine.model_selector(args, length)
    if fused:
        jm = jm.clone(fused=True)
    # The checkpoint fills the tree; its shapes are all the template needs.
    params = jax.eval_shape(jm.init, jax.random.key(0),
                            jnp.zeros((STEP_BATCH, 3, length, 32, 32)))["params"]
    params = jengine.load_ckpt(params, args.ckpt)
    jopt = J.make_optimizer(args.lr, ema=args.ema)
    jstate = jopt.init(params)
    jstep = J.make_train_step(jm, "InT", jopt)
    start = {n: np.asarray(v) for n, v in params.items()}
    jparams = jax.tree.map(jnp.copy, params)
    out = []
    for i in range(len(clips)):
        jparams, jstate, jstats = jstep(jparams, jstate, jnp.asarray(clips[i]),
                                        jnp.asarray(labels[i]))
        trees = {"weights": jparams}
        if args.ema is not None:
            trees["ema"] = J.ema_params(jstate)
        out.append((np.asarray(jstats["loss"]), {w: {n: np.array(v) for n, v in tree.items()}
                                                 for w, tree in trees.items()}))
    return start, out


def test_fused_cell_at_the_plateau_is_the_jax_packages_default_cell(tmp_path):
    """Stage A's steps from the JAX chainA's last checkpoint on the chance
    plateau (epoch 38) through the port's fused cell (K1-K3's plain
    versions; the cell ``--bf16`` trains on) are the JAX package's default
    cell's (its eager mixed cell, the one ``mainclean.py --bf16`` trains
    on), the weights' move within NORM_RTOL in length after each step and
    at cosine at least PLATEAU_COS_MIN. On the plateau the batch norm's
    direct input cotangent and its statistics' part nearly cancel; both
    cells add them in f32 and round the sum to bf16 once."""
    _steps_match("A", tmp_path, fused=True, jax_fused=False, cos_min=PLATEAU_COS_MIN)


def test_fused_cells_at_the_plateau_part_from_the_eager_cell(tmp_path):
    """The gap between the cells on the plateau, pinned: from the JAX
    chainA's epoch 38, the JAX package's opt-in fused cell (its Pallas
    kernels, which round the batch norm's direct input cotangent to bf16
    and add the statistics' part in bf16) moves the weights more than
    NORM_RTOL further than its eager cell (the cell the JAX chain trained
    on) after two steps; the port's fused cell, which sums the two parts in
    f32 and rounds once, and its eager cell keep within NORM_RTOL of it.
    tests/torch_cell_gradients.py's plateau case gives the gradients per
    parameter against f64."""
    start, port_fused, jax_eager = _window("A", tmp_path, fused=True, jax_fused=False)
    _, port_eager, jax_fused = _window("A", tmp_path, fused=False, jax_fused=True)
    last = {who: _moves(start, steps[-1][1], jax_eager[-1][1])["weights"]
            for who, steps in (("port fused", port_fused), ("JAX fused", jax_fused),
                               ("port eager", port_eager))}
    assert last["JAX fused"][1] - 1.0 > NORM_RTOL, last
    assert abs(last["port fused"][1] - 1.0) <= NORM_RTOL, last
    assert abs(last["port eager"][1] - 1.0) <= NORM_RTOL, last
