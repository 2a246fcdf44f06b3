"""Meshes, sharding rules and the active groups
(pathtracker_tpu/parallel/mesh.py).

Data parallelism (mesh.py:22-61): one process a card, the batch split over
the ranks in rank order, the weights and optimizer state replicated. The
JAX package shards a global array over a 'data' axis and lets GSPMD turn
every batch reduction into a global one; here each rank holds its slice of
the batch, and the reductions that must be global go through the *active
groups*: ``ops/int_fused.stats`` and ``ops/layers.batch_norm`` (the
BatchNorm statistics: sync-BN, as layers.py:1-10 and :144-162),
``utils/metrics.acc_scores`` (the meters, from global counts) and the train
and eval steps (the gradient, the loss). The loop sets the group for a run
(``data_group``); without one every function here is the identity and the
single-process path is unchanged.

Model parallelism (mesh.py:73-199): ``make_mesh_2d`` lays the world's ranks
out as ``np.reshape(n_data, n_model)`` lays out devices, with a process
group per row and per column. The sharding rules (``channel_shardings``,
``fsdp_shardings``, ``hybrid_shardings``) are JAX's, evaluated on the JAX
names and layouts of the port's parameters (``train/torch_import``) and
mapped back to torch's dims: JAX's ``[3,3,64,64]`` shards its input
channels, which are dim 1 of torch's ``[64,64,3,3]``. ``*_shard_params``
return a ``Sharded``: between steps each rank keeps only its block of
every parameter, and the optimizer updates the blocks (Adam's moments are
block-shaped, ``count`` a host int). A step gathers the whole weights into
the module, runs forward and backward, hands each block its gradient and
empties the module again, so during a step a rank holds the whole weights
and their whole gradients: the storage and the optimizer state are
sharded, the step's working set is not (ZeRO-1 in memory while a step
runs; the JAX package's per-layer gathers under GSPMD are not copied). Under tensor parallelism the convs and projections compute
their rank's output channels and gather them (``model_split``), and the
fused K1-K3 kernels run on the gathered channels with the gathered gate
matrices on every model rank, as GSPMD runs the JAX package's custom call
on replicated operands. Spatial parallelism (``spatial_layout``; the JAX
package's ``P("data", None, "space")`` on the clips) runs InT on a rank's
rows of H, with halo rows for the k x k convs (``space_split``).

Which group a reduction goes through depends on the layout, so
``data_group`` names one per role:

    data    the meters and the logged loss: the ranks that hold different
            clips
    stats   the BatchNorm statistics and the gradient's mean: data, or
            data x space under spatial parallelism (a rank's rows of H are
            part of every channel's statistics and every weight's gradient)
    space   the spatial axis: halos and ``global_avg_pool``'s sum
    model   the tensor-parallel axis: ``model_split``

A group of one rank computes what no group does, bit for bit: its
all-reduces are copies, and a model or space group of one splits nothing.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.distributed as dist

from pathtracker_torch.parallel.collectives import (all_gather, gather_channels, halo_rows,
                                                    reduce_scatter, replicated_input)


class DataMesh:
    """One mesh axis over a process group (the default one: the world):
    ``size`` ranks, this one ``rank``. As a mesh of its own it is 1-D, its
    one axis named ``name``."""

    def __init__(self, group=None, name: str = "data"):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.name = name
        self.shape = {name: self.size}

    def axis(self, name: str) -> "DataMesh":
        if name != self.name:
            raise KeyError(f"a mesh of axis {self.name!r} has no axis {name!r}")
        return self

    @property
    def world(self) -> "DataMesh":
        return self

    def __repr__(self):
        return f"DataMesh({self.name}: rank {self.rank} of {self.size})"


def make_mesh(n_devices: int | None = None, axis_name: str = "data") -> DataMesh:
    """The 1-D mesh over the initialized process group (``n_devices``, if
    given, must be its size: one card a process)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.initialize() first")
    mesh = DataMesh(name=axis_name)
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"a mesh of {n_devices} devices over a world of {mesh.size} "
                         "processes: one card a process")
    return mesh


class Mesh2D:
    """The world's ranks as an ``n0 x n1`` grid in rank order (rank
    ``i * n1 + j`` at ``(i, j)``), with the group of each axis: ``axis(a0)``
    is this rank's column (the ranks that differ in the first index),
    ``axis(a1)`` its row."""

    def __init__(self, n0: int, n1: int, axis_names: tuple[str, str]):
        world, rank = dist.get_world_size(), dist.get_rank()
        if n0 * n1 != world:
            raise ValueError(f"a {n0} x {n1} mesh over a world of {world} processes")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (n0, n1)))
        self.coords = dict(zip(self.axis_names, divmod(rank, n1)))
        self.world = DataMesh(name="world")
        self._axes = {}
        # Every rank creates every group, in one order (new_group is a
        # collective of the world): the rows, then the columns.
        for members, name in ([(list(range(i * n1, (i + 1) * n1)), self.axis_names[1])
                               for i in range(n0)]
                              + [(list(range(j, world, n1)), self.axis_names[0])
                                 for j in range(n1)]):
            group = None if len(members) == world else dist.new_group(members)
            if rank in members:
                self._axes[name] = DataMesh(group, name)

    def axis(self, name: str) -> DataMesh:
        return self._axes[name]

    def __repr__(self):
        return f"Mesh2D({self.shape}, at {self.coords})"


def make_mesh_2d(n_data: int, n_model: int,
                 axis_names: tuple[str, str] = ("data", "model")) -> Mesh2D:
    """The 2-D mesh (mesh.py:73-82): batch over the first axis, channels,
    rows of H or experts over the second (or stages over the first)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh_2d needs a process group: call "
                           "parallel.distributed.initialize() first")
    return Mesh2D(n_data, n_model, axis_names)


def _rows(x, mesh: DataMesh, dim: int = 0):
    n = x.shape[dim]
    if n % mesh.size:
        raise ValueError(f"a dim of {n} over {mesh.size} ranks")
    b = n // mesh.size
    return x.narrow(dim, mesh.rank * b, b)


def shard_batch(mesh, batch):
    """This rank's slice of a global batch (a tensor or array, or a tuple of
    them, batch-major) over the mesh's data axis: rows [rank*b, (rank+1)*b)
    with b = batch / size, so the ranks' slices concatenated in rank order
    are the global batch."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, x) for x in batch)
    axis = mesh.axis("data") if not isinstance(mesh, DataMesh) else mesh
    n = batch.shape[0]
    if n % axis.size:
        raise ValueError(f"a batch of {n} over {axis.size} ranks")
    b = n // axis.size
    return batch[axis.rank * b:(axis.rank + 1) * b]


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


# ------------------------------ active groups --------------------------------

_ROLES = ("data", "stats", "space", "model")
_ACTIVE: dict = dict.fromkeys(_ROLES)


def active_mesh(role: str = "data") -> DataMesh | None:
    """The group the reductions of ``role`` go through in a run, or None."""
    return _ACTIVE[role]


@contextmanager
def data_group(mesh: DataMesh | None, **roles):
    """Run the body with ``mesh`` as the active data group. ``roles`` names
    the group of the others (``stats``, ``space``, ``model``); stats
    defaults to ``mesh``, space and model to none."""
    unknown = set(roles) - set(_ROLES[1:])
    if unknown:
        raise TypeError(f"no reduction role {sorted(unknown)}; roles are {_ROLES}")
    active = {"data": mesh, "stats": mesh, "space": None, "model": None, **roles}
    saved = dict(_ACTIVE)
    _ACTIVE.update(active)
    try:
        yield mesh
    finally:
        _ACTIVE.update(saved)


def pmean(x, over: str = "data"):
    """Mean of ``x`` over the ranks of the active ``over`` group
    (``lax.pmean``), differentiable; ``x`` itself without a group. Every
    rank holds the same number of rows, so the mean of the ranks' means is
    the global mean."""
    mesh = _ACTIVE[over]
    if mesh is None:
        return x
    return all_reduce_sum(x, mesh) / mesh.size


def psum(x, over: str = "data"):
    """Sum of ``x`` over the ranks of the active ``over`` group,
    differentiable; ``x`` itself without a group."""
    mesh = _ACTIVE[over]
    return x if mesh is None else all_reduce_sum(x, mesh)


@torch.no_grad()
def average_gradients(grads):
    """The mean over the active ``stats`` group's ranks of each gradient,
    summed in one flat bucket per dtype; the list itself without a group. A
    None (a parameter the step does not reach) is None on every rank, which
    all run one graph, and stays None."""
    mesh = _ACTIVE["stats"]
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


def model_split(op, weight_dim: int, out_dim: int):
    """``op(x, w, **kw)`` (a conv or a matmul) split over the active model
    group: each rank computes the output channels of its block of ``w``
    along ``weight_dim`` and the blocks are gathered along ``out_dim``
    (channel_shardings' rule: an output width the group divides; others,
    and grouped convs, run whole). ``op`` itself without a model group."""
    mesh = _ACTIVE["model"]
    if mesh is None or mesh.size == 1:
        return op

    def split(x, w, **kw):
        cout = w.shape[weight_dim]
        if cout % mesh.size or cout < mesh.size or kw.get("groups", 1) != 1:
            return op(x, w, **kw)
        part = cout // mesh.size
        y = op(replicated_input(x, mesh), w.narrow(weight_dim, mesh.rank * part, part), **kw)
        return gather_channels(y, mesh, out_dim % y.dim())
    return split


def space_split(conv, kernel_h: int):
    """``conv(x_nchw, w, padding="same", ...)`` on this rank's rows of H
    under the active space group: the rows a 'SAME' conv reads from the
    neighbouring ranks come first (``halo_rows``), and the output is cropped
    back to the rank's rows. ``conv`` itself without a space group."""
    mesh = _ACTIVE["space"]
    if mesh is None or mesh.size == 1 or kernel_h == 1:
        return conv
    above, below = (kernel_h - 1) // 2, kernel_h // 2

    def halo_conv(x, w, **kw):
        y = conv(halo_rows(x, mesh, above, below, 2), w, **kw)
        return y.narrow(2, above, x.shape[2])
    return halo_conv


# ----------------------------- sharding rules --------------------------------

_CODE = 1 << 12  # a parameter's index times this, plus an index along one dim


def _jax_axes(shapes: dict) -> dict:
    """{name: (JAX shape, torch dim of each JAX axis)} for the port's
    parameters of ``shapes`` ({state_dict key: shape}), through the same
    name and layout map as checkpoints (``torch_import.to_jax_params``).
    Each dim is found by sending an index along it through the map; a JAX
    axis of size 1 maps to None."""
    from pathtracker_torch.train.torch_import import jax_leaves, to_jax_params

    names = list(shapes)
    if len(names) * _CODE > 1 << 24 or any(max(s, default=1) >= _CODE
                                          for s in shapes.values()):
        raise ValueError("too many or too wide parameters for the layout probe")
    out: dict = {}
    for d in range(max(len(s) for s in shapes.values())):
        probe = {}
        for i, name in enumerate(names):
            shape = tuple(shapes[name])
            value = torch.full(shape, float(i * _CODE))
            if d < len(shape):
                value += torch.arange(shape[d], dtype=torch.float32).view(
                    [-1 if j == d else 1 for j in range(len(shape))])
            probe[name] = value
        for _, leaf in jax_leaves(to_jax_params(probe)):
            name = names[int(leaf.reshape(-1)[0]) // _CODE]
            dims = out.setdefault(name, (tuple(leaf.shape), [None] * leaf.ndim))[1]
            for j in range(leaf.ndim):
                if leaf.shape[j] > 1 and (leaf.take(1, axis=j) != leaf.take(0, axis=j)).any():
                    dims[j] = d
    return out


def _fsdp_axis(shape, n: int, min_elements: int, exclude: int | None = None):
    """JAX's fsdp_shardings rule (mesh.py:133-149) on a JAX shape, passing
    over the dim ``exclude`` (hybrid_shardings' model dim)."""
    if not shape or max(shape) < max(n, min_elements):
        return None
    best = -1
    for i, d in enumerate(shape):
        if i != exclude and d % n == 0 and (best < 0 or d > shape[best]):
            best = i
    return None if best < 0 else best


def _channel_axis(shape, n: int):
    """JAX's channel_shardings rule (mesh.py:99-104): the last dim."""
    if not shape or shape[-1] % n != 0 or shape[-1] < n:
        return None
    return len(shape) - 1


def _specs(params, rule) -> dict:
    """{name: spec} for the port's ``params`` ({name: tensor or shape}):
    ``rule(jax_shape) -> {jax axis: mesh axis}``, mapped to torch's dims."""
    shapes = {k: tuple(getattr(v, "shape", v)) for k, v in params.items()}
    specs = {}
    for name, (jshape, dims) in _jax_axes(shapes).items():
        spec = [None] * len(shapes[name])
        for j, axis in rule(jshape).items():
            if dims[j] is not None:  # a dim of one is whole on every rank
                spec[dims[j]] = axis
        specs[name] = tuple(spec)
    return specs


def channel_shardings(mesh, params, model_axis: str = "model") -> dict:
    """Tensor-parallel specs (mesh.py:85-104): each parameter's output
    channels (JAX's last dim: dim 0 of a torch conv or linear weight) split
    over ``model_axis`` where its size divides them; readout heads and odd
    sizes replicate. A spec names, per torch dim, the mesh axis it is split
    over (None: whole)."""
    n = mesh.shape[model_axis]

    def rule(shape):
        j = _channel_axis(shape, n)
        return {} if j is None else {j: model_axis}
    return _specs(params, rule)


def fsdp_shardings(mesh, params, axis: str = "data", min_elements: int = 2) -> dict:
    """ZeRO-3 specs (mesh.py:118-149): each parameter's largest dim that
    ``axis`` divides, ties to the first, in JAX's layout; parameters smaller
    than the axis (per-channel scalars) replicate."""
    n = mesh.shape[axis]

    def rule(shape):
        j = _fsdp_axis(shape, n, min_elements)
        return {} if j is None else {j: axis}
    return _specs(params, rule)


def hybrid_shardings(mesh, params, data_axis: str = "data", model_axis: str = "model",
                     min_elements: int = 2) -> dict:
    """FSDP x TP specs (mesh.py:162-192): the last dim over ``model_axis``
    as channel_shardings, and the largest remaining dim ``data_axis``
    divides over it."""
    n_data, n_model = mesh.shape[data_axis], mesh.shape[model_axis]

    def rule(shape):
        out = {}
        tp = _channel_axis(shape, n_model)
        if tp is not None:
            out[tp] = model_axis
        dp = _fsdp_axis(shape, n_data, min_elements, exclude=tp)
        if dp is not None:
            out[dp] = data_axis
        return out
    return _specs(params, rule)


# ---------------------------- sharded parameters -----------------------------

class Sharded:
    """A model's trainable parameters laid out over a mesh: the port's
    counterpart of a parameter pytree after ``jax.device_put`` with
    NamedShardings. ``specs[name]`` names, per torch dim, the mesh axis the
    parameter is split over. This rank keeps its block of each
    (``shards``, in ``names`` order: what the optimizer updates); the
    module's own tensors are empty outside a step and whole inside one.

    ``gather`` fills the module with the whole weights; ``reduce`` turns
    the whole weights' gradients of this rank's loss into the blocks'
    gradients: along a dim split over the model axis the rank keeps its
    block (what follows the gather is replicated there), along the data
    axis the blocks' sum is scattered (ZeRO's reduce-scatter) and a
    replicated gradient is all-reduced, each divided into the mean over the
    ``stats`` group; ``release`` empties the module. ``groups`` is the
    ``data_group`` a step runs under and ``local_batch`` this rank's block
    of a global batch."""

    def __init__(self, mesh, model, specs: dict, *, data_axis: str = "data",
                 model_axis: str | None = None, space_axis: str | None = None):
        self.mesh, self.model, self.specs = mesh, model, specs
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.data_axis = data_axis
        data = mesh.axis(data_axis)
        world = mesh.world if space_axis else data
        self.roles = dict(stats=world,
                          space=mesh.axis(space_axis) if space_axis else None,
                          model=mesh.axis(model_axis) if model_axis else None)
        self.data = data
        self.shards = [self._block(p.detach(), specs[n]).clone()
                       for n, p in named]
        self.release()

    def _block(self, full, spec):
        for d, axis in enumerate(spec):
            if axis is not None:
                full = _rows(full, self.mesh.axis(axis), d)
        return full

    def groups(self):
        return data_group(self.data, **self.roles)

    def local_batch(self, batch):
        """This rank's clips (and labels) of a global batch: rows over the
        data axis; under spatial parallelism, rows of H (dim 2 of
        [B, T, H, W, 3] clips) over the space axis."""
        if isinstance(batch, (tuple, list)):
            return type(batch)(self.local_batch(x) for x in batch)
        x = _rows(batch, self.data, 0)
        space = self.roles["space"]
        if space is not None and x.dim() > 2:
            x = _rows(x, space, 2)
        return x

    @torch.no_grad()
    def gather(self) -> None:
        for p, full in zip(self.params, gather_params(self).values(), strict=True):
            p.data = full

    def release(self) -> None:
        for p in self.params:
            p.data = p.data.new_empty(0)

    @torch.no_grad()
    def reduce(self, grads) -> list:
        grads = list(grads)
        whole = []
        for i, (g, name) in enumerate(zip(grads, self.names, strict=True)):
            if g is None:
                continue
            scatter = None
            for d, axis in enumerate(self.specs[name]):
                if axis == self.data_axis:
                    scatter = d
                elif axis is not None:  # the model axis: this rank's block
                    g = _rows(g, self.mesh.axis(axis), d)
            if scatter is None:
                whole.append(i)
                grads[i] = g
            else:
                grads[i] = reduce_scatter(g, self.data, scatter) / self.data.size
        with data_group(self.data, stats=self.roles["stats"]):
            for i, g in zip(whole, average_gradients([grads[i] for i in whole]), strict=True):
                grads[i] = g
        return grads


@torch.no_grad()
def gather_params(sharded: Sharded) -> dict:
    """The whole weights {name: tensor} of a ``Sharded`` (a collective:
    every rank calls it), for comparisons and checkpoints."""
    out = {}
    for shard, name in zip(sharded.shards, sharded.names, strict=True):
        full = shard
        for d, axis in enumerate(sharded.specs[name]):
            if axis is not None:
                full = all_gather(full, sharded.mesh.axis(axis), d)
        out[name] = full.clone() if full is shard else full
    return out


def _model_params(model) -> dict:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def fsdp_shard_params(mesh, model, axis: str = "data") -> Sharded:
    """``model``'s parameters under fsdp_shardings (mesh.py:152-159): bind
    the optimizer to ``.shards`` and its moments are sharded too."""
    return Sharded(mesh, model, fsdp_shardings(mesh, _model_params(model), axis),
                   data_axis=axis)


def shard_params_2d(mesh, model, model_axis: str = "model") -> Sharded:
    """``model``'s parameters under channel_shardings, replicated over the
    mesh's other axis, the data axis (mesh.py:107-110)."""
    data_axis = next(a for a in mesh.axis_names if a != model_axis)
    return Sharded(mesh, model, channel_shardings(mesh, _model_params(model), model_axis),
                   data_axis=data_axis, model_axis=model_axis)


def hybrid_shard_params(mesh, model, data_axis: str = "data",
                        model_axis: str = "model") -> Sharded:
    """``model``'s parameters under hybrid_shardings (mesh.py:195-199)."""
    return Sharded(mesh, model, hybrid_shardings(mesh, _model_params(model), data_axis,
                                                 model_axis),
                   data_axis=data_axis, model_axis=model_axis)


def spatial_layout(mesh, model, data_axis: str = "data", space_axis: str = "space") -> Sharded:
    """Spatial parallelism (the JAX package's ``P("data", None, "space")``
    on the clips, parameters replicated): every parameter whole on every
    rank, a rank's clips its rows of the batch and of H, the statistics and
    the gradient's mean over data x space."""
    specs = {n: (None,) * p.dim() for n, p in _model_params(model).items()}
    return Sharded(mesh, model, specs, data_axis=data_axis, space_axis=space_axis)
