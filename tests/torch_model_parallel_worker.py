#!/usr/bin/env python3
"""One rank of the port's model-parallel tests
(tests/test_torch_model_parallel.py on the CPU, tests/test_torch_cuda.py on
the card): joins a process group through a file store, runs every case of
an input file on the mesh the case names, and saves what each computed.

    python tests/torch_model_parallel_worker.py RANK WORLD STORE IN OUT [DEVICE [BACKEND]]

IN is a ``torch.save`` of {name: case}; OUT receives {name: result}. DEVICE
is ``cpu`` (the default: gloo, torch on one thread) or ``cuda``. The worker
imports torch and the port only: no JAX, no conftest. Cases
(``case["kind"]``):

    step      one make_train_step of InT or rntsm under a layout
              (``mode``: fsdp, tp, hybrid, sp) on a mesh (``mesh``), from
              the case's weights on its global batch (``f64``: rntsm in
              float64, its correlation the plain version): the stats, the whole
              weights after (gather_params), the specs, this rank's shards
              and Adam moments, the gradients' None count, whether the
              module is empty after the step, K1-K3 launches
    pipeline  pipeline_apply on a ('stage', 'data') mesh and the gradients
              of sum(y**2) in the stacked parameters and this rank's rows
    moe       moe_apply_sharded on an ('expert',) or ('data', 'expert')
              mesh and the gradients of mean(y**2) over the global rows
    world1    (a world of one) a step under size-1 FSDP, TP and SP meshes
              and with no group, from the same weights: both results
    collectives  parallel.collectives on seeded tensors, f32 and bf16
"""

from __future__ import annotations

import contextlib
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pathtracker_torch.ops import int_fused as F  # noqa: E402
from pathtracker_torch.parallel import distributed  # noqa: E402
from pathtracker_torch.parallel import mesh as M  # noqa: E402
from pathtracker_torch.parallel.mesh import data_group  # noqa: E402


class SGD:
    """Plain SGD with the Optimizer's binding (``init``/``step``), for the
    rntsm comparisons: its update is the gradient itself."""

    def __init__(self, lr: float):
        self.lr, self.params = lr, None

    def init(self, params):
        self.params = list(params)
        return self

    @torch.no_grad()
    def step(self, grads):
        for p, g in zip(self.params, grads, strict=True):
            if g is not None:
                p.sub_(self.lr * g.to(p.dtype))


def _mesh(shape, names):
    if len(shape) == 1:
        return M.make_mesh(axis_name=names[0])
    return M.make_mesh_2d(*shape, tuple(names))


def _model(case, device):
    if case["model"] == "rntsm":
        from pathtracker_torch.models.tsm_resnet import TSMResNet

        model = TSMResNet(device=device, fused=not case.get("f64"), **case["kwargs"])
        if case.get("f64"):
            model = model.double()
    else:
        from pathtracker_torch.models.int_circuit import InT

        model = InT(device=device, **case["kwargs"])
    model.load_state_dict({k: v.to(device) for k, v in case["state"].items()}, strict=True)
    return model.train()


LAYOUTS = {"fsdp": lambda mesh, m: M.fsdp_shard_params(mesh, m),
           "tp": lambda mesh, m: M.shard_params_2d(mesh, m),
           "hybrid": lambda mesh, m: M.hybrid_shard_params(mesh, m),
           "sp": lambda mesh, m: M.spatial_layout(mesh, m)}
AXES = {"fsdp": ("data",), "tp": ("data", "model"), "hybrid": ("data", "model"),
        "sp": ("data", "space")}


def run_step(case, device, mode, shape):
    """One step of ``case`` under ``mode`` on a mesh of ``shape`` (mode None:
    no group, the whole batch)."""
    from pathtracker_torch.train.steps import make_optimizer, make_train_step

    model = _model(case, device)
    opt = SGD(case["lr"]) if case.get("sgd") else make_optimizer(case["lr"])
    clips, labels = case["clips"].to(device), case["labels"].to(device)
    for k in F.KERNELS:
        k.launches = 0
    if mode is None:
        stats = make_train_step(model, case["model"], opt)(clips, labels)
        return {"stats": torch.tensor([float(v) for v in stats.values()]),
                "state": {k: v.detach().cpu() for k, v in model.state_dict().items()}}
    layout = LAYOUTS[mode](_mesh(shape, AXES[mode]), model)
    seen = {}
    reduce = layout.reduce

    def recording(grads):
        grads = list(grads)
        seen["none"] = sum(g is None for g in grads)
        seen["zero"] = sum(g is not None and not bool(g.any()) for g in grads)
        out = reduce(grads)
        seen["shard_grads"] = [None if g is None else tuple(g.shape) for g in out]
        return out

    layout.reduce = recording
    step = make_train_step(model, case["model"], opt, layout=layout)
    stats = step(*layout.local_batch((clips, labels)))
    empty = all(p.numel() == 0 for p in layout.params)
    moments = ([tuple(t.shape) for t in opt.mu] if hasattr(opt, "mu") else [])
    return {"stats": torch.tensor([float(v) for v in stats.values()]),
            "state": {k: v.cpu() for k, v in M.gather_params(layout).items()},
            "specs": layout.specs, "names": layout.names,
            "shards": [tuple(t.shape) for t in layout.shards], "moments": moments,
            "count": getattr(opt, "count", None), "empty": empty, **seen,
            "launches": torch.tensor([k.launches for k in F.KERNELS])}


@contextlib.contextmanager
def f64_inputs():
    """The train step's clips in f64, and the BatchNorm statistics of f64
    inputs in f64 (tests/torch_parallel_worker.py's ``f64_statistics``)."""
    from torch_parallel_worker import f64_statistics

    from pathtracker_torch.train import steps

    prepare = steps.prepare_batch

    def widened(*args, **kwargs):
        imgs, target = prepare(*args, **kwargs)
        return imgs.double(), target.double()

    steps.prepare_batch = widened
    try:
        with f64_statistics():
            yield
    finally:
        steps.prepare_batch = prepare


def case_step(case, device):
    with f64_inputs() if case.get("f64") else contextlib.nullcontext():
        return run_step(case, device, case["mode"], case["mesh"])


def _stage_fn(p, h):
    from pathtracker_torch.ops.layers import conv2d

    return torch.relu(conv2d(h, p["k"], p["b"]))


def case_pipeline(case, device):
    from pathtracker_torch.parallel.pipeline import pipeline_apply

    mesh = _mesh(case["mesh"], ("stage", "data"))
    stacked = {k: v.to(device).requires_grad_() for k, v in case["stacked"].items()}
    x = M.shard_batch(mesh, case["x"].to(device)).requires_grad_()
    y = pipeline_apply(mesh, _stage_fn, stacked, x, batch_axis="data")
    grads = torch.autograd.grad((y ** 2).sum(), [x, *stacked.values()])
    return {"y": y.detach().cpu(), "dx": grads[0].cpu(),
            **{f"d{k}": g.cpu() for k, g in zip(stacked, grads[1:])}}


def case_moe(case, device):
    from pathtracker_torch.parallel.moe import (_gates, moe_apply_sharded,
                                                shard_moe_params)

    names = ("data", "expert") if len(case["mesh"]) == 2 else ("expert",)
    mesh = _mesh(case["mesh"], names)
    params = {k: v.to(device).requires_grad_() for k, v in
              shard_moe_params(mesh, case["params"]).items()}
    x = case["x"].to(device)
    batch_axis = "data" if "data" in names else None
    if batch_axis:
        x = M.shard_batch(mesh, x)
    y = moe_apply_sharded(mesh, params, x, batch_axis=batch_axis)
    # mean(y**2) over the global rows: each rank's rows' share of it
    loss = (y ** 2).sum() / (case["x"].shape[0] * y.shape[1])
    grads = torch.autograd.grad(loss, list(params.values()))
    grads = dict(zip(params, grads))
    if batch_axis:  # the router's and the experts' sums over the data axis
        with data_group(mesh.axis("data")):
            grads = dict(zip(grads, (g * mesh.axis("data").size for g in
                                     M.average_gradients(list(grads.values())))))
    return {"y": y.detach().cpu(), "gates": _gates(params["router_w"], x).detach().cpu(),
            **{k: g.cpu() for k, g in grads.items()}}


def case_world1(case, device):
    out = {"none": run_step(case, device, None, None)}
    for mode in ("fsdp", "tp", "sp"):
        out[mode] = run_step(case, device, mode, (1,) if mode == "fsdp" else (1, 1))
    return out


def case_collectives(case, device):
    """parallel.collectives on this rank's seeded tensors (rank r's x is
    arange + 100 r), in f32 and bf16: each result, and the halo's gradient
    of sum(w * halo_rows(x)) for a seeded w."""
    from pathtracker_torch.parallel import collectives as C

    mesh = M.make_mesh()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.arange(24, dtype=torch.float32).view(4, 6) + 100 * mesh.rank).to(
            device, dtype)
        tag = str(dtype).split(".")[-1]
        out[f"gather0-{tag}"] = C.all_gather(x, mesh, 0).cpu()
        out[f"gather1-{tag}"] = C.all_gather(x, mesh, 1).cpu()
        out[f"scatter0-{tag}"] = C.reduce_scatter(x, mesh, 0).cpu()
        out[f"scatter1-{tag}"] = C.reduce_scatter(x, mesh, 1).cpu()
        out[f"shift+1-{tag}"] = C.shift(x, mesh, 1).cpu()
        out[f"shift-1-{tag}"] = C.shift(x, mesh, -1).cpu()
        out[f"broadcast-{tag}"] = C.broadcast_from(x, mesh, mesh.size - 1).cpu()
        xin = x.view(1, 1, 4, 6).requires_grad_()
        y = C.halo_rows(xin, mesh, 2, 1, 2)
        w = torch.linspace(-1, 1, y.numel(), device=device).view_as(y).to(dtype)
        out[f"halo-{tag}"] = y.detach().cpu()
        out[f"halo_grad-{tag}"] = torch.autograd.grad((w * y).sum(), xin)[0].cpu()
    return out


CASES = {"step": case_step, "pipeline": case_pipeline, "moe": case_moe, "world1": case_world1,
         "collectives": case_collectives}


def main(rank: int, world: int, store: str, inp: str, out: str, device: str = "cpu",
         backend: str | None = None) -> None:
    torch.set_num_threads(1)
    dev = distributed.initialize(f"file://{store}", world, rank, backend=backend,
                                 device=device, timeout_s=300)
    torch.backends.cudnn.deterministic = True  # results compared bit for bit on the card
    try:
        cases = torch.load(inp)
        results = {name: CASES[case["kind"]](case, dev) for name, case in cases.items()}
        torch.save(results, out)
        distributed.barrier("done", timeout_s=300)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])
