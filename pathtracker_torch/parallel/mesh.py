"""The data-parallel mesh (pathtracker_tpu/parallel/mesh.py:22-61): one
process a card, the batch split over the ranks in rank order, the weights
and optimizer state replicated.

The JAX package shards a global array over a 'data' axis and lets GSPMD turn
every batch reduction into a global one; here each rank holds its slice of
the batch, and the reductions that must be global go through the *active
data group*: ``ops/int_fused.stats`` and ``ops/layers.batch_norm`` (the
BatchNorm statistics: sync-BN, as layers.py:1-10 and :144-162),
``utils/metrics.acc_scores`` (the meters, from global counts) and the train
and eval steps (the gradient, the loss). The loop sets the group for a
run (``data_group``); without one every function here is the identity and
the single-process path is unchanged.

A group of one rank computes what no group does, bit for bit: its
all-reduces are copies.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.distributed as dist


class DataMesh:
    """A 1-D 'data' axis over a process group (the default one): ``size``
    ranks, this one ``rank``."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def __repr__(self):
        return f"DataMesh(rank {self.rank} of {self.size})"


def make_mesh(n_devices: int | None = None) -> DataMesh:
    """The data axis over the initialized process group (``n_devices``, if
    given, must be its size: one card a process)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.initialize() first")
    mesh = DataMesh()
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"a mesh of {n_devices} devices over a world of {mesh.size} "
                         "processes: one card a process")
    return mesh


def shard_batch(mesh: DataMesh, batch):
    """This rank's slice of a global batch (a tensor or array, or a tuple of
    them, batch-major): rows [rank*b, (rank+1)*b) with b = batch / size, so
    the ranks' slices concatenated in rank order are the global batch."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, x) for x in batch)
    n = batch.shape[0]
    if n % mesh.size:
        raise ValueError(f"a batch of {n} over {mesh.size} ranks")
    b = n // mesh.size
    return batch[mesh.rank * b:(mesh.rank + 1) * b]


@torch.no_grad()
def replicate_tree(mesh: DataMesh, tensors) -> None:
    """Rank 0's values of ``tensors`` (an iterable of tensors, updated in
    place) on every rank: the weights and the optimizer state, so that each
    rank starts from the same ones after --ckpt or --auto-resume, which read
    only rank 0's results folder."""
    for t in tensors:
        dist.broadcast(t, src=0, group=mesh.group)


class _AllReduce(torch.autograd.Function):
    """SUM over the group's ranks. Its backward is the same Function on the
    cotangent, so a backward that is itself differentiated (the Jacobian
    penalty's ``create_graph``) reduces its cotangents too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g.contiguous(), ctx.group), None


def all_reduce_sum(x, mesh: DataMesh):
    """Differentiable sum of ``x`` over the mesh's ranks."""
    return _AllReduce.apply(x, mesh.group)


_ACTIVE: dict = {"mesh": None}


def active_mesh() -> DataMesh | None:
    """The data group the reductions of a run go through, or None."""
    return _ACTIVE["mesh"]


@contextmanager
def data_group(mesh: DataMesh | None):
    """Run the body with ``mesh`` as the active data group."""
    saved, _ACTIVE["mesh"] = _ACTIVE["mesh"], mesh
    try:
        yield mesh
    finally:
        _ACTIVE["mesh"] = saved


def pmean(x):
    """Mean of ``x`` over the active group's ranks (``lax.pmean``),
    differentiable; ``x`` itself without a group. Every rank holds the same
    number of rows, so the mean of the ranks' means is the global mean."""
    mesh = _ACTIVE["mesh"]
    if mesh is None:
        return x
    return all_reduce_sum(x, mesh) / mesh.size


def psum(x):
    """Sum of ``x`` over the active group's ranks, differentiable; ``x``
    itself without a group."""
    mesh = _ACTIVE["mesh"]
    return x if mesh is None else all_reduce_sum(x, mesh)


@torch.no_grad()
def average_gradients(grads):
    """The mean over the active group's ranks of each gradient, summed in
    one flat bucket per dtype; the list itself without a group. A None (a
    parameter the step does not reach) is None on every rank, which all run
    one graph, and stays None."""
    mesh = _ACTIVE["mesh"]
    if mesh is None:
        return grads
    grads = list(grads)
    by_dtype: dict = {}
    for i, g in enumerate(grads):
        if g is not None:
            by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=mesh.group)
        flat /= mesh.size
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx]), strict=True):
            grads[i] = part.view_as(grads[i])
    return grads
