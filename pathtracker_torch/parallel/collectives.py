"""The collectives of the model-parallel modes, over one axis of a mesh
(a ``DataMesh``: a process group, this rank's index in it and its size).

GSPMD inserts these in the JAX package; here each is called where the
computation needs it, and each that carries a gradient is a
``torch.autograd.Function`` whose backward is its transpose under the rule
the modes share: the computation after a gather or a sum is replicated over
the axis's ranks, so each rank's own cotangent is the whole cotangent.

    gather_channels    all-gather along a dim; backward: this rank's block
    replicated_input   identity; backward: the sum over the axis (the
                       input feeds a split computation, each rank a part)
    psum_replicated    the sum over the axis; backward: identity
    broadcast_from     rank ``src``'s tensor on every rank; backward: the
                       source keeps its cotangent, the others give none
    halo_rows          a neighbour's boundary rows above and below along H;
                       backward: the halo's cotangent back to its owner

``all_gather``, ``reduce_scatter`` and ``shift`` carry no gradient. Every
function works on the card's tensors over gloo (several ranks on one card,
where NCCL refuses) and NCCL. Gloo's all-reduce, broadcast, all-gather and
reduce-scatter take the card's tensors; its send and receive do not (on the
card, torch 2.11: the process aborts, "Bad address"), so over gloo on the
card a shift is an all-gather and a pick.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _via_gloo(x, mesh) -> bool:
    return x.is_cuda and dist.get_backend(mesh.group) == "gloo"


def _gather_list(x, mesh) -> list:
    """Every rank's ``x`` (same shape on each), in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return parts


def all_gather(x, mesh, dim: int = 0):
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    if mesh.size == 1:
        return x.clone()
    return torch.cat(_gather_list(x, mesh), dim=dim)


def reduce_scatter(x, mesh, dim: int = 0):
    """This rank's block along ``dim`` of the sum of the ranks' ``x``."""
    n = mesh.size
    if x.shape[dim] % n:
        raise ValueError(f"a dim of {x.shape[dim]} scattered over {n} ranks")
    if n == 1:
        return x.clone()
    rows = x.movedim(dim, 0).contiguous()
    out = rows.new_empty((rows.shape[0] // n, *rows.shape[1:]))
    dist.reduce_scatter_tensor(out, rows, group=mesh.group)
    return out.movedim(0, dim).contiguous()


def shift(x, mesh, offset: int = 1):
    """``lax.ppermute`` over the ring ``i -> i + offset``: the ``x`` of rank
    ``rank - offset`` (mod size). Every rank of the axis calls it together."""
    n = mesh.size
    if n == 1:
        return x.clone()
    src = (mesh.rank - offset) % n
    if _via_gloo(x, mesh):
        return _gather_list(x, mesh)[src]
    ranks = dist.get_process_group_ranks(mesh.group) if mesh.group is not None else range(n)
    ranks = list(ranks)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), ranks[(mesh.rank + offset) % n], mesh.group),
           dist.P2POp(dist.irecv, out, ranks[src], mesh.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.part = mesh, dim, x.shape[dim]
        return all_gather(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.mesh.rank * ctx.part, ctx.part), None, None


def gather_channels(x, mesh, dim: int):
    """The ranks' blocks of ``x`` along ``dim``, concatenated; its backward
    keeps this rank's block of the cotangent (what follows is replicated)."""
    return _GatherChannels.apply(x, mesh, dim)


class _ReplicatedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = g.contiguous().clone()
        if ctx.mesh.size > 1:
            dist.all_reduce(total, group=ctx.mesh.group)
        return total, None


def replicated_input(x, mesh):
    """``x`` as it enters a computation split over the axis: the identity,
    whose backward sums the ranks' partial cotangents (Megatron's f)."""
    return _ReplicatedInput.apply(x, mesh)


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        total = x.contiguous().clone()
        if mesh.size > 1:
            dist.all_reduce(total, group=mesh.group)
        return total

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum_replicated(x, mesh):
    """The sum of the ranks' parts (``lax.psum``) where what follows is
    replicated: its backward hands each part the cotangent as it is
    (Megatron's g)."""
    return _PsumReplicated.apply(x, mesh)


class _BroadcastFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, src):
        ctx.mesh, ctx.src = mesh, src
        out = x.contiguous().clone()
        if mesh.size > 1:
            ranks = (list(dist.get_process_group_ranks(mesh.group))
                     if mesh.group is not None else list(range(mesh.size)))
            dist.broadcast(out, ranks[src], group=mesh.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.mesh.rank == ctx.src else torch.zeros_like(g)), None, None


def broadcast_from(x, mesh, src: int):
    """Axis rank ``src``'s ``x`` on every rank of the axis."""
    return _BroadcastFrom.apply(x, mesh, src)


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, above, below, dim):
        ctx.mesh, ctx.above, ctx.below, ctx.dim = mesh, above, below, dim
        rows = x.shape[dim]
        if rows < max(above, below):
            raise ValueError(f"{rows} rows a rank under a halo of {above}/{below}")
        # Each rank hands out its first `below` rows (the halo of the rank
        # above it) and its last `above` rows (that of the rank below).
        edge = torch.cat([x.narrow(dim, 0, below), x.narrow(dim, rows - above, above)], dim)
        edges = _gather_list(edge, mesh)
        r, n = mesh.rank, mesh.size
        top = (edges[r - 1].narrow(dim, below, above) if r > 0
               else x.new_zeros(x.shape[:dim] + (above,) + x.shape[dim + 1:]))
        bottom = (edges[r + 1].narrow(dim, 0, below) if r < n - 1
                  else x.new_zeros(x.shape[:dim] + (below,) + x.shape[dim + 1:]))
        return with_halo(top, x, bottom, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, above, below, dim = ctx.mesh, ctx.above, ctx.below, ctx.dim
        rows = g.shape[dim] - above - below
        gx = g.narrow(dim, above, rows).clone()
        # The cotangent of the rows this rank took from its neighbours goes
        # back to them: the top halo to the rank above, the bottom one below.
        edge = torch.cat([g.narrow(dim, 0, above), g.narrow(dim, above + rows, below)], dim)
        edges = _gather_list(edge, mesh)
        r, n = mesh.rank, mesh.size
        if r < n - 1:  # the rank below took my last rows as its top halo
            gx.narrow(dim, rows - above, above).add_(edges[r + 1].narrow(dim, 0, above))
        if r > 0:  # the rank above took my first rows as its bottom halo
            gx.narrow(dim, 0, below).add_(edges[r - 1].narrow(dim, above, below))
        return gx, None, None, None, None


def with_halo(top, x, bottom, dim: int):
    """``x`` between its halo rows along ``dim``; a 4-D result channels-last
    (the layout a conv of the port takes), whatever the parts' layouts."""
    out = torch.cat([top, x, bottom], dim)
    return out.contiguous(memory_format=torch.channels_last) if out.dim() == 4 else out


def halo_rows(x, mesh, above: int, below: int, dim: int):
    """``x`` with ``above`` rows of the rank above it and ``below`` of the
    rank below it along ``dim`` (zeros past the first and last rank), as a
    'SAME' convolution over the whole axis reads them."""
    return _HaloRows.apply(x, mesh, above, below, dim)
