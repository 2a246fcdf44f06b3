#!/usr/bin/env python3
"""One rank of the port's data-parallel tests (tests/test_torch_parallel.py
on the CPU, tests/test_torch_cuda.py on the card): joins a process group
through a file store, runs every case of an input file under the data
group, and saves what each case computed.

    python tests/torch_parallel_worker.py RANK WORLD STORE IN OUT [DEVICE [BACKEND]]

IN is a ``torch.save`` of {name: case}; OUT receives {name: result}. DEVICE
is ``cpu`` (the default: gloo, torch on one thread) or ``cuda`` (the card,
NCCL unless BACKEND names another). The worker imports torch and the port
only: no JAX, no conftest. Cases (``case["kind"]``):

    bn        int_fused.stats and layers.batch_norm on this rank's rows of
              a global f64 batch, their values and input gradients
    penalty   ops.penalty.jacobian_penalty of a step with a BatchNorm in
              it, f64: the all-reduce inside autograd.grad, and the double
              backward to the inputs and weights
    meters    utils.metrics.acc_scores of this rank's half of a batch
    step      make_train_step's steps of an InT on this rank's slices of
              global batches: stats, the final weights, K1-K3 launches and
              step seconds
    resident  make_resident_train_step over the mesh: the rank's slice of
              the clips, its steps' stats, the clips each step gathered
    world1    (a world of one) a step and a resident window each with the
              group and with none, from the same weights: both results
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pathtracker_torch.ops import int_fused as F  # noqa: E402
from pathtracker_torch.ops.layers import batch_norm  # noqa: E402
from pathtracker_torch.ops.penalty import jacobian_penalty  # noqa: E402
from pathtracker_torch.parallel import distributed  # noqa: E402
from pathtracker_torch.parallel.mesh import (active_mesh, data_group, make_mesh,  # noqa: E402
                                             shard_batch)
from pathtracker_torch.utils.metrics import acc_scores  # noqa: E402


@contextlib.contextmanager
def f64_statistics():
    """BatchNorm statistics in f64 for f64 inputs (both BN sites take them
    in f32 by design: ``x.float()``), so that a global batch's statistics
    and their gradients compare at f64 rounding."""
    real = torch.Tensor.float

    def widened(self, *args, **kwargs):
        return self if self.dtype == torch.float64 else real(self, *args, **kwargs)

    torch.Tensor.float = widened
    try:
        yield
    finally:
        torch.Tensor.float = real


def case_bn(mesh, case, device):
    x = shard_batch(mesh, case["x"]).to(device).requires_grad_()
    y = shard_batch(mesh, case["y"]).to(device).requires_grad_()
    scale, bias = (case[k].to(device).requires_grad_() for k in ("scale", "bias"))
    with f64_statistics():
        mean, rstd = F.stats(x)
        # Each rank's share of one global objective: the statistics'
        # cotangents split over the ranks, the rows' own.
        obj = ((mean * case["gm"].to(device)).sum()
               + (rstd * case["gr"].to(device)).sum()) / mesh.size
        dx, = torch.autograd.grad(obj, x)
        out = batch_norm(y, scale, bias)
        dy, dscale, dbias = torch.autograd.grad(
            (out * shard_batch(mesh, case["gy"]).to(device)).sum(), (y, scale, bias))
    return {k: v.detach().cpu() for k, v in dict(mean=mean, rstd=rstd, dx=dx, out=out, dy=dy,
                                                  dscale=dscale, dbias=dbias).items()}


def penalty_step(w, scale, bias):
    """One recurrent step with a BatchNorm over the batch in it."""
    return lambda h: torch.tanh(batch_norm(h @ w, scale, bias))


def case_penalty(mesh, case, device):
    h = shard_batch(mesh, case["h"]).to(device).requires_grad_()
    w, scale, bias = (case[k].to(device).requires_grad_() for k in ("w", "scale", "bias"))
    with f64_statistics():
        pen = jacobian_penalty(penalty_step(w, scale, bias), h)
        grads = torch.autograd.grad(pen / mesh.size, (h, w, scale, bias))
    return {"penalty": pen.detach().cpu(),
            **{k: g.cpu() for k, g in zip(("dh", "dw", "dscale", "dbias"), grads)}}


def case_meters(mesh, case, device):
    target, logits = (shard_batch(mesh, case[k]).to(device) for k in ("target", "logits"))
    return {"global": torch.stack(acc_scores(target, logits)).cpu(),
            "local": torch.stack(_local(acc_scores, target, logits)).cpu()}


def _local(fn, *args):
    with data_group(None):
        return fn(*args)


def _int(case, device):
    from pathtracker_torch.models.int_circuit import InT

    model = InT(device=device, **case["model"])
    model.load_state_dict({k: v.to(device) for k, v in case["state"].items()}, strict=True)
    return model


def _launches():
    return torch.tensor([k.launches for k in F.KERNELS])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def case_step(mesh, case, device):
    from pathtracker_torch.train.steps import make_optimizer, make_train_step

    model = _int(case, device)
    step = make_train_step(model, "InT", make_optimizer(case["lr"]), penalty=case["penalty"])
    stats, seconds = [], []
    for k in F.KERNELS:
        k.launches = 0
    for clips, labels in zip(case["clips"], case["labels"]):
        clips, labels = shard_batch(mesh, (clips, labels))
        _sync(device)
        t0 = time.perf_counter()
        got = step(clips.to(device), labels.to(device))
        _sync(device)
        seconds.append(time.perf_counter() - t0)
        stats.append(torch.tensor([float(v) for v in got.values()], dtype=torch.float64))
    return {"stats": torch.stack(stats), "seconds": torch.tensor(seconds),
            "launches": _launches(), "fused": torch.tensor(model.use_fused),
            "state": {k: v.detach().cpu() for k, v in model.state_dict().items()}}


def case_resident(mesh, case, device):
    from pathtracker_torch.data import resident
    from pathtracker_torch.train.steps import make_optimizer

    model = _int(case, device)
    clips, labels = (shard_batch(mesh, case[k]).to(device) for k in ("clips", "labels"))
    gathered = []
    prepare = resident.prepare_batch

    def recording(raw_imgs, raw_labels, **kw):
        gathered.append(raw_imgs[:, 0, 0, 0, 0].long().cpu())  # a clip's own index
        return prepare(raw_imgs, raw_labels, **kw)

    resident.prepare_batch = recording
    try:
        step = resident.make_resident_train_step(
            model, "InT", make_optimizer(case["lr"]), n_clips=int(case["labels"].shape[0]),
            batch_size=case["batch"], seed=case["seed"], fused_steps=case["fused"],
            mesh=active_mesh())
        stats = [torch.tensor(step(clips, labels)["loss"], dtype=torch.float64).reshape(-1)
                 for _ in range(case["windows"])]
    finally:
        resident.prepare_batch = prepare
    steps = sum(len(s) for s in stats)
    return {"loss": torch.cat(stats), "gathered": torch.stack(gathered),
            "indices": torch.stack([step.indices(s).cpu() for s in range(steps)]),
            "state": {k: v.detach().cpu() for k, v in model.state_dict().items()}}


def case_world1(mesh, case, device):
    """The same step and resident window with the group of one and with no
    group: their results side by side, for a bitwise comparison."""
    out = {}
    for name, group in (("group", mesh), ("none", None)):
        with data_group(group):
            out[name] = {"step": case_step(mesh, case, device),
                         "resident": case_resident(mesh, {**case, **case["resident"]}, device)}
    return out


CASES = {"bn": case_bn, "penalty": case_penalty, "meters": case_meters, "step": case_step,
         "resident": case_resident, "world1": case_world1}


def main(rank: int, world: int, store: str, inp: str, out: str, device: str = "cpu",
         backend: str | None = None) -> None:
    torch.set_num_threads(1)
    dev = distributed.initialize(f"file://{store}", world, rank, backend=backend,
                                 device=device, timeout_s=300)
    try:
        mesh = make_mesh()
        cases = torch.load(inp)
        results = {}
        with data_group(mesh):
            for name, case in cases.items():
                results[name] = CASES[case["kind"]](mesh, case, dev)
        torch.save(results, out)
        distributed.barrier("done", timeout_s=300)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])
