"""The multi-rank dry run of every parallel mode
(``__graft_entry__.py::_dryrun_local``), one process a rank:

    python -m pathtracker_torch.parallel.dryrun --ranks N [--device cpu]

starts N ranks of this module and waits for them. On the card they run over
NCCL, one card a rank, or over gloo on the cards when the ranks outnumber
them (NCCL refuses two ranks on one card); with ``--device cpu``, over gloo
on the CPU. Each rank runs, with the JAX dry run's shapes and checks:

  * dp: an InT step (dims 8, T 4, kernel 3) on a global batch of 2N clips;
  * FSDP: the same step with the parameters and Adam's moments sharded, its
    loss within 1e-3 of dp's;
  * rntsm under FSDP: a (1,1,1,1) bottleneck TSM-ResNet with the
    MotionSqueeze, its layer-4 kernels sharded, a finite loss;
  * when N is even, dp x tp and dp x sp on N/2 x 2 meshes, losses within
    1e-3 of dp's;
  * when N % 4 == 0, dp x ep (an 8-expert MoE over ('data', 'expert') =
    N/4 x 4, one Adam step, the loss within 1e-5 of the dense oracle's) and
    pp x dp (a 4-stage GPipe conv trunk over ('stage', 'data') = 4 x N/4,
    one Adam step of BCE, the loss within 1e-5 of the sequential oracle's
    and every updated parameter within rtol 1e-4 / atol 1e-5).

Rank 0 prints a line a mode. The command exits non-zero if any rank fails;
the others are stopped then.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pathtracker_torch.parallel import distributed
from pathtracker_torch.parallel import mesh as M


def _say(msg: str) -> None:
    if distributed.is_primary():
        print(f"dryrun({distributed.world_size()}): {msg}", flush=True)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _int_step(dev, layout_of=None, mesh=None):
    """One InT step on the global batch of the JAX dry run's shapes (the
    global batch from seed 0, this rank's block of it): its loss."""
    from pathtracker_torch.models.int_circuit import InT
    from pathtracker_torch.train.steps import make_optimizer, make_train_step

    n = distributed.world_size()
    batch, t = 2 * n, 4
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 255, size=(batch, t, 32, 32, 3), dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 2, size=(batch,), dtype=np.uint8))
    model = InT(dimensions=8, timesteps=t, kernel_size=3, device=dev).train()
    opt = make_optimizer(3e-4)
    if layout_of is None:
        with M.data_group(mesh):
            stats = make_train_step(model, "InT", opt)(*M.shard_batch(mesh, (imgs, labels)))
        return float(stats["loss"]), None
    layout = layout_of(model)
    stats = make_train_step(model, "InT", opt, layout=layout)(
        *layout.local_batch((imgs, labels)))
    return float(stats["loss"]), layout


def _rntsm_fsdp(dev, mesh) -> tuple[float, dict]:
    from pathtracker_torch.models.tsm_resnet import TSMResNet
    from pathtracker_torch.train.steps import make_optimizer, make_train_step

    n, t = mesh.size, 4
    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(rng.integers(0, 255, size=(n, t, 16, 16, 3), dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 2, size=(n,), dtype=np.uint8))
    model = TSMResNet(layers=(1, 1, 1, 1), num_segments=t, flow_estimation=True, patch=5,
                      block="bottleneck", seed=1, device=dev).train()
    layout = M.fsdp_shard_params(mesh, model)
    stats = make_train_step(model, "rntsm", make_optimizer(3e-4), layout=layout)(
        *layout.local_batch((imgs, labels)))
    return float(stats["loss"]), layout.specs


def _moe_step(dev, n):
    from pathtracker_torch.parallel.moe import (init_moe_params, moe_apply, moe_apply_sharded,
                                                shard_moe_params)
    from pathtracker_torch.train.steps import make_optimizer

    mesh = M.make_mesh_2d(n // 4, 4, ("data", "expert"))
    data = mesh.axis("data")
    params = init_moe_params(torch.Generator().manual_seed(7), 8, 16, 32, device=dev)
    rows = torch.randn(4 * n, 16, generator=torch.Generator().manual_seed(8)).to(dev)
    local = shard_moe_params(mesh, params)
    opt = make_optimizer(1e-3).init(list(local.values()))
    for p in local.values():
        p.requires_grad_()
    y = moe_apply_sharded(mesh, local, M.shard_batch(mesh, rows), batch_axis="data")
    share = (y ** 2).sum() / (rows.shape[0] * y.shape[1])  # this rank's part of the mean
    grads = torch.autograd.grad(share, list(local.values()))
    with M.data_group(data):
        loss = float(M.psum(share.detach()))
        grads = [g * data.size for g in M.average_gradients(grads)]  # the sum over data
    opt.step(grads)
    want = float((moe_apply(params, rows) ** 2).mean())
    return loss, want


def _pipe_stage(p, h):
    from pathtracker_torch.ops.layers import conv2d

    return torch.relu(conv2d(h, p["k"], p["b"]))


def _pp_step(dev, n):
    from pathtracker_torch.parallel.pipeline import pipeline_apply, stack_stage_params
    from pathtracker_torch.train.steps import make_optimizer
    from pathtracker_torch.utils.metrics import bce_with_logits

    n_data, width = n // 4, 8
    mesh = M.make_mesh_2d(4, n_data, ("stage", "data"))
    gen = torch.Generator().manual_seed(3)
    stages = [{"k": 0.2 * torch.randn(width, width, 3, 3, generator=gen),
               "b": torch.zeros(width)} for _ in range(4)]
    h0 = torch.randn(4 * n_data, 16, 16, width, generator=gen).to(dev)
    yb = (torch.arange(4 * n_data) % 2).float().to(dev)

    def params():
        return {**{k: v.to(dev) for k, v in stack_stage_params(stages).items()},
                "w_out": torch.zeros(width, 1, device=dev), "b_out": torch.zeros(1, device=dev)}

    def head(p, feat):
        return feat.mean(dim=(1, 2)) @ p["w_out"] + p["b_out"]

    # The pipelined step: this rank's rows, the gradient's mean over data.
    pp = params()
    opt = make_optimizer(1e-3).init(list(pp.values()))
    for v in pp.values():
        v.requires_grad_()
    x, y = M.shard_batch(mesh, (h0, yb))
    feat = pipeline_apply(mesh, _pipe_stage, {"k": pp["k"], "b": pp["b"]}, x,
                          batch_axis="data")
    loss = bce_with_logits(head(pp, feat)[:, 0], y)
    grads = torch.autograd.grad(loss, list(pp.values()))
    with M.data_group(mesh.axis("data")):
        opt.step(M.average_gradients(grads))
        loss = float(M.pmean(loss.detach()))
    # The sequential oracle: the same trunk stage after stage on the batch.
    sp = params()
    sopt = make_optimizer(1e-3).init(list(sp.values()))
    for v in sp.values():
        v.requires_grad_()
    h = h0
    for i in range(4):
        h = _pipe_stage({"k": sp["k"][i], "b": sp["b"][i]}, h)
    sloss = bce_with_logits(head(sp, h)[:, 0], yb)
    sopt.step(torch.autograd.grad(sloss, list(sp.values())))
    worst = max(float(((a - b).abs() - 1e-4 * b.abs()).max())
                for a, b in zip(opt.params, sopt.params))
    return loss, float(sloss), worst


def run_rank(dev) -> None:
    n = distributed.world_size()
    world = M.make_mesh()
    loss, _ = _int_step(dev, mesh=world)
    _check(np.isfinite(loss), f"non-finite dp loss {loss}")
    _say(f"dp step ok, loss={loss:.5f}")

    loss_f, layout = _int_step(dev, lambda m: M.fsdp_shard_params(world, m))
    _check(np.isfinite(loss_f) and abs(loss_f - loss) < 1e-3, f"fsdp {loss_f} vs dp {loss}")
    sharded = sum(any(s) for s in layout.specs.values())
    _say(f"fsdp step ok, loss={loss_f:.5f} ({sharded} of {len(layout.specs)} parameters "
         f"sharded over 'data')")

    rloss, specs = _rntsm_fsdp(dev, world)
    wide = {k: s for k, s in specs.items() if k.startswith("layer4.0.conv")}
    _check(bool(wide) and all("data" in s for s in wide.values()),
           f"rntsm layer4 not fsdp-sharded: {wide}")
    _check(np.isfinite(rloss), f"non-finite rntsm fsdp loss {rloss}")
    _say(f"rntsm fsdp step ok, loss={rloss:.5f} (layer4 kernels sharded over 'data')")

    if n % 2 == 0:
        loss2, _ = _int_step(dev, lambda m: M.shard_params_2d(M.make_mesh_2d(n // 2, 2), m))
        _check(np.isfinite(loss2) and abs(loss2 - loss) < 1e-3, f"dp x tp {loss2} vs {loss}")
        _say(f"dp x tp step ok, loss={loss2:.5f}")
        loss3, _ = _int_step(dev, lambda m: M.spatial_layout(
            M.make_mesh_2d(n // 2, 2, ("data", "space")), m))
        _check(np.isfinite(loss3) and abs(loss3 - loss) < 1e-3, f"dp x sp {loss3} vs {loss}")
        _say(f"dp x sp step ok, loss={loss3:.5f}")

    if n % 4 == 0:
        eloss, eref = _moe_step(dev, n)
        _check(np.isfinite(eloss) and abs(eloss - eref) < 1e-5, f"dp x ep {eloss} vs {eref}")
        _say(f"dp x ep moe step ok, loss={eloss:.5f} == dense {eref:.5f}")
        ploss, sloss, worst = _pp_step(dev, n)
        _check(np.isfinite(ploss) and abs(ploss - sloss) < 1e-5, f"pp {ploss} vs {sloss}")
        _check(worst <= 1e-5, f"pp updated params past rtol 1e-4 / atol 1e-5 by {worst}")
        _say(f"pp x dp pipeline step ok, loss={ploss:.5f} == sequential {sloss:.5f}, "
             "updated params match")


def _rank_main(args) -> int:
    dev = distributed.initialize(f"file://{args.store}", args.ranks, args.rank,
                                 backend=args.backend, device=args.device, timeout_s=300)
    try:
        run_rank(dev)
        distributed.barrier("done", timeout_s=300)
    finally:
        distributed.shutdown()
    return 0


def launch(ranks: int, device: str | None = None, timeout_s: float = 900.0) -> int:
    """Start ``ranks`` processes of this module and wait for them; a rank
    that fails stops the others. Returns the first non-zero exit code, or
    0."""
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the dry run on the CPU")
    backend = None
    if device != "cpu" and ranks > torch.cuda.device_count():
        backend = "gloo"  # NCCL refuses two ranks on one card
    with tempfile.TemporaryDirectory() as tmp:
        argv = [sys.executable, "-m", "pathtracker_torch.parallel.dryrun", "--ranks",
                str(ranks), "--store", os.path.join(tmp, "store")]
        argv += ["--device", device] if device else []
        argv += ["--backend", backend] if backend else []
        env = {**os.environ, "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS", "1")}
        procs = [subprocess.Popen(argv + ["--rank", str(r)], env=env) for r in range(ranks)]
        deadline = time.time() + timeout_s
        rc = 0
        try:
            while any(p.poll() is None for p in procs):
                if time.time() > deadline:
                    rc = rc or 124
                    break
                failed = [p.returncode for p in procs if p.returncode not in (None, 0)]
                if failed:
                    rc = failed[0]
                    break
                time.sleep(0.2)
            rc = rc or next((p.returncode for p in procs if p.returncode), 0)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
    return rc


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", type=int, required=True)
    parser.add_argument("--device", default=None, help="cpu, or the card by default")
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--store", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--backend", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        if args.device == "cpu":
            torch.set_num_threads(1)
        return _rank_main(args)
    rc = launch(args.ranks, args.device)
    if rc:
        print(f"dryrun({args.ranks}): a rank failed (exit {rc})", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
