"""Pipeline parallelism over a mesh axis (pathtracker_tpu/parallel/pipeline.py).

A GPipe stage pipeline: each rank of the 'stage' axis holds one stage of a
stack of shape-preserving stages, microbatches enter at stage 0 and are
handed from stage i to stage i+1 each tick (``collectives.shift``, the
counterpart of ``lax.ppermute``). With S stages and M microbatches the
schedule runs S+M-1 ticks (bubble (S-1)/(S+M-1), the GPipe bound); the last
stage emits once the pipe is full, and its outputs are broadcast over the
stage axis, in input order.

The whole schedule is one ``torch.autograd.Function``. Its backward runs
the ticks in reverse, each stage recomputing its microbatch from the input
it saved (GPipe's re-materialisation) and handing the input's cotangent
back one stage: every rank calls the same collectives in the same order,
forward and backward, so no ordering of sends and receives can deadlock.
The stacked parameters' gradient comes back whole on every stage rank (each
stage fills its row, summed over the axis), as does the input's.

Contract: ``stage_fn(stage_params, x) -> y`` is shape- and
dtype-preserving (homogeneous stages), ``stage_params`` a dict of tensors
stacked on a leading stage axis (``stack_stage_params``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pathtracker_torch.parallel.collectives import broadcast_from, shift


def stack_stage_params(params_list) -> dict:
    """Stack per-stage param dicts along a new leading 'stage' axis."""
    return {k: torch.stack([p[k] for p in params_list]) for k in params_list[0]}


def _ticks(n_stages: int, n_micro: int, stage: int):
    """(tick, microbatch) of this stage's work, in schedule order."""
    return [(k, k - stage) for k in range(n_micro + n_stages - 1)
            if 0 <= k - stage < n_micro]


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, xm, *weights):
        axis, stage_fn, names = run
        n_stages, stage, n_micro = axis.size, axis.rank, xm.shape[0]
        w = {n: v[stage] for n, v in zip(names, weights, strict=True)}
        work = dict(_ticks(n_stages, n_micro, stage))
        buf = torch.zeros_like(xm[0])
        outs = torch.zeros_like(xm)
        inputs = {}
        for k in range(n_micro + n_stages - 1):
            y = torch.zeros_like(buf)
            if k in work:
                cur = xm[work[k]] if stage == 0 else buf
                inputs[k] = cur
                y = stage_fn(w, cur)
                if stage == n_stages - 1:
                    outs[work[k]] = y
            buf = shift(y, axis, 1)
        ctx.run, ctx.inputs = run, inputs
        ctx.save_for_backward(*weights)
        return broadcast_from(outs, axis, n_stages - 1)

    @staticmethod
    def backward(ctx, g_out):
        axis, stage_fn, names = ctx.run
        weights = ctx.saved_tensors
        n_stages, stage, n_micro = axis.size, axis.rank, g_out.shape[0]
        work = dict(_ticks(n_stages, n_micro, stage))
        rows = [w[stage].detach().requires_grad_() for w in weights]
        w = dict(zip(names, rows, strict=True))
        g_rows = [torch.zeros_like(r) for r in rows]
        g_x = torch.zeros_like(g_out)
        back = torch.zeros_like(g_out[0])  # the cotangent of this tick's output
        for k in reversed(range(n_micro + n_stages - 1)):
            # What the next stage handed back for my output of tick k.
            received = shift(back, axis, -1)
            back = torch.zeros_like(back)
            if k not in work:
                continue
            m = work[k]
            g_y = g_out[m] if stage == n_stages - 1 else received
            cur = ctx.inputs[k].detach().requires_grad_()
            with torch.enable_grad():
                y = stage_fn(w, cur)
            g_cur, *g_w = torch.autograd.grad(y, [cur, *rows], g_y, allow_unused=True)
            for acc, g in zip(g_rows, g_w):
                if g is not None:
                    acc += g
            if stage == 0:
                g_x[m] = g_cur
            else:
                back = g_cur
        g_weights = []
        for wt, g in zip(weights, g_rows):
            full = torch.zeros_like(wt)
            full[stage] = g
            g_weights.append(full)
        if n_stages > 1:
            flat = torch.cat([g.reshape(-1) for g in (g_x, *g_weights)])
            dist.all_reduce(flat, group=axis.group)
            parts = flat.split([g.numel() for g in (g_x, *g_weights)])
            g_x, *g_weights = (p.view_as(g) for p, g in zip(parts, (g_x, *g_weights)))
        return (None, g_x, *g_weights)


def pipeline_apply(mesh, stage_fn, stage_params: dict, x, *, n_microbatches: int | None = None,
                   stage_axis: str = "stage", batch_axis: str | None = None):
    """Run ``x`` through the stacked stages, pipelined over ``stage_axis``.

    ``stage_params`` holds every stage's parameters stacked on axis 0 (each
    stage rank uses its row); ``x`` is [B, ...] with B % n_microbatches == 0
    (n_microbatches defaults to the number of stages). With ``batch_axis``
    the microbatches' content is split over that axis: ``x`` is this rank's
    rows of the batch, and so is the result. Returns [B, ...] in input
    order, the same on every stage rank; differentiable in ``x`` and the
    stacked parameters."""
    axis = mesh.axis(stage_axis)
    if next(iter(stage_params.values())).shape[0] != axis.size:
        raise ValueError(f"{next(iter(stage_params.values())).shape[0]} stages over a "
                         f"stage axis of {axis.size}")
    n_micro = n_microbatches or axis.size
    batch = x.shape[0]
    if batch % n_micro:
        raise ValueError(f"a batch of {batch} in {n_micro} microbatches")
    xm = x.reshape(n_micro, batch // n_micro, *x.shape[1:])
    names = tuple(stage_params)
    out = _Pipeline.apply((axis, stage_fn, names), xm, *(stage_params[n] for n in names))
    return out.reshape(batch, *x.shape[1:])
