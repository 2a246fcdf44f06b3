"""Device-resident datasets (pathtracker_tpu/data/resident.py): the whole
uint8 dataset is uploaded once and every batch is a gather on the device, so
the host's decode, shuffle and copy leave the steady state.

Shuffle: a fresh permutation an epoch, drawn on the device from (seed,
epoch) exactly as the JAX package draws it (data/prng.py), so a port run
takes the same batches in the same order as a JAX run.

``--fused-steps K``: the JAX package runs a window of K optimizer steps as
one compiled ``lax.scan`` program (:207-221). Here a window on the card is
one CUDA graph of K steps (gather, prep, forward, backward, the optimizer,
the stats), captured the first time a window of its length and
accumulation phase comes and replayed after, every graph of a run in one
memory pool (they replay one at a time, on one stream, and keep nothing
they allocate past a replay); its inputs are static buffers
(the resident clips, the epoch's permutation, the window's first step and
the optimizer's per-step scalars) and its output a static [K, 7] stats
buffer fetched once a window. A capture or replay that fails raises; no
window falls back to eager steps. On the CPU, which a caller must ask for, a
window is K eager steps of the same code and one stats fetch.
"""

from __future__ import annotations

import glob as _glob

import numpy as np
import torch
import torch.distributed as dist

from pathtracker_torch import resolve_device
from pathtracker_torch.data import native as _native
from pathtracker_torch.data import prng
from pathtracker_torch.data.prepare import prepare_batch
from pathtracker_torch.data.tfrecord import read_clip_records
from pathtracker_torch.engine import DROPOUT_MODELS, model_step
from pathtracker_torch.parallel.mesh import active_mesh, average_gradients, data_group
from pathtracker_torch.train.steps import TRAIN_KEYS, train_stats
from pathtracker_torch.utils.metrics import bce_with_logits


def load_resident(data_dir: str, timesteps: int, height: int = 32,
                  width: int = 32, limit: int | None = None, device=None):
    """Every shard matching the glob, in order, as (clips [N,T,H,W,3] uint8,
    labels [N] uint8) on ``device`` (cuda where None)."""
    device = resolve_device(device)
    files = sorted(_glob.glob(data_dir))
    if not files:
        raise FileNotFoundError(f"no shards match {data_dir}")
    all_clips, all_labels = [], []
    n = 0
    for path in files:
        if _native.available():
            with _native.ShardView(path, timesteps, height, width) as shard:
                take = len(shard)
                if limit is not None:
                    take = min(take, limit - n)
                # Real copies: the views belong to the reader's handle, and
                # the next shard's decode reuses that buffer (a kept view
                # became the next shard's clips under this shard's labels:
                # 50% label noise in the JAX package, resident.py:45-52).
                all_clips.append(shard.clips[:take].copy())
                all_labels.append(shard.labels[:take].copy())
        else:
            clips, labels = [], []
            for clip, label in read_clip_records(path, timesteps, height, width):
                clips.append(clip)
                labels.append(label)
                if limit is not None and n + len(clips) >= limit:
                    break
            take = len(clips)
            all_clips.append(np.stack(clips))
            all_labels.append(np.asarray(labels, np.uint8))
        n += take
        if limit is not None and n >= limit:
            break
    clips = torch.from_numpy(np.concatenate(all_clips)).to(device)
    labels = torch.from_numpy(np.concatenate(all_labels)).to(device)
    return clips, labels


class ResidentBatches:
    """Re-iterable batches gathered on the device from resident tensors
    (validation). ``shuffle`` reshuffles every iteration with
    ``np.random.default_rng(seed)``, the reference's val loader
    (resident.py:70-83: a fixed val slice would leave EarlyStopping's metric
    constant through the long chance-level plateau); the remainder is
    dropped."""

    def __init__(self, clips, labels, batch_size: int, shuffle: bool = True,
                 seed: int = 0):
        self.clips = clips
        self.labels = labels
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        n = int(self.labels.shape[0])
        b = self.batch_size
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        for i in range(0, n - b + 1, b):
            idx = torch.as_tensor(order[i:i + b], device=self.clips.device)
            yield self.clips.index_select(0, idx), self.labels.index_select(0, idx)


def make_resident_train_step(model, model_name: str, optimizer, n_clips: int,
                             batch_size: int, penalty: bool = False,
                             prepare_kwargs: dict | None = None, seed: int = 0,
                             fused_steps: int = 1, mesh=None):
    """``train_step(clips, labels) -> stats`` over resident tensors on the
    model's device (resident.py:104-247).

    Each call runs one window of steps: step ``s`` (a count kept here, from
    0) gathers slot ``s % steps_per_epoch`` of the permutation of epoch
    ``s // steps_per_epoch``, and a window is ``fused_steps`` steps, cut
    short where the epoch ends. The parameters and ``optimizer`` are updated
    in place. Stats are TRAIN_KEYS scalars when ``fused_steps`` is 1 and
    ``[k]`` arrays otherwise, from one host fetch a window. The step carries
    ``steps_per_epoch``, ``fused_steps`` and ``windows_per_epoch``,
    ``graphs``, {(k, phase): CUDAGraph} of the windows captured on the card
    (``phase``: micro-steps into the accumulation window at its start), and
    ``indices(s)``, the clip indices step ``s`` gathers.

    Over a data mesh (``mesh``, by default the active data group;
    resident.py:146-194) ``n_clips`` and ``batch_size`` are the global
    counts, both multiples of the mesh's size; each rank holds its
    ``n_clips / size`` slice of the clips in rank order and gathers
    ``batch_size / size`` of them a step from its own permutation, the
    rank's index folded into the key; ``steps_per_epoch`` comes from the
    global counts, and ``indices(s)`` are local. The windows run under the
    mesh, so a graph captured over NCCL holds the statistics' and the
    gradient's collectives; gloo's cannot be captured, and a mesh over gloo
    on the card raises."""
    if "rbp" in getattr(model, "grad_method", "bptt"):
        # Each Neumann term's exit test reads a norm back to the host
        # (ops/rbp.py), which a CUDA graph cannot hold.
        raise ValueError("--algo rbp cannot run in a resident window: its "
                         "backward syncs with the host every Neumann term")
    prep = dict(prepare_kwargs or {})
    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device
    mesh = mesh if mesh is not None else active_mesh()
    ranks, dev = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    if n_clips % ranks or batch_size % ranks:
        raise ValueError(f"{n_clips} resident clips and a batch of {batch_size} over "
                         f"{ranks} ranks: both must be multiples of it")
    if mesh is not None and device.type == "cuda" and dist.get_backend(mesh.group) != "nccl":
        raise ValueError(f"resident windows on the card are CUDA graphs, which cannot hold "
                         f"{dist.get_backend(mesh.group)}'s collectives: train over NCCL, "
                         "or without --device-data")
    if optimizer.params is None:
        optimizer.init(params)
    fused = max(1, int(fused_steps))
    optimizer.reserve(fused)
    steps_per_epoch = max(n_clips // batch_size, 1)
    n_local, b_local = n_clips // ranks, batch_size // ranks
    # Static buffers the windows read and write.
    first = torch.zeros((), dtype=torch.int64, device=device)
    perm = torch.zeros(n_local, dtype=torch.int64, device=device)
    lanes = torch.arange(b_local, device=device)
    stats = torch.zeros((fused, len(TRAIN_KEYS)), dtype=torch.float32, device=device)
    state = {"count": 0, "epoch": None, "bound": None, "pool": None, "side": None}
    # The generator of the models' stochastic layers (SlowFast's dropout), as
    # make_train_step's; a captured window draws from it on every replay.
    generator = torch.Generator(device=device).manual_seed(seed)
    draws = model_name in DROPOUT_MODELS

    def gather(order, slot):
        """Slot ``slot`` of an epoch's order. Batches tile the permutation;
        the mod keeps a slot valid when the batch does not divide the
        dataset, and a slot of the global count valid on a rank's slice
        (resident.py:180-183)."""
        return order.index_select(0, (slot * b_local + lanes) % n_local)

    def indices(step: int):
        return gather(prng.epoch_permutation(seed, step // steps_per_epoch, n_local, device,
                                             dev),
                      step % steps_per_epoch)

    def window(clips, labels, k: int) -> None:
        """Steps first .. first+k-1 on the device alone: nothing here
        reads a value back or branches on one."""
        for j in range(k):
            idx = gather(perm, (first + j) % steps_per_epoch)
            raw_imgs, raw_labels = clips.index_select(0, idx), labels.index_select(0, idx)
            imgs, target = prepare_batch(raw_imgs, raw_labels, **prep)
            output, jv_penalty = model_step(model, imgs, model_name, generator=generator)
            loss = bce_with_logits(output, target)
            jv = jv_penalty.mean()
            total = loss + jv * 1e1 if penalty else loss
            optimizer.apply(average_gradients(
                torch.autograd.grad(total, params, allow_unused=True)), j)
            with torch.no_grad():
                stats[j].copy_(train_stats(loss, total, jv, raw_labels, output))

    graphs: dict = {}

    def capture(clips, labels, k: int, phase: int):
        """Warm the window up on a side stream (cuDNN's plans, the kernel
        libraries, the allocator), put back the weights and optimizer state
        the warm-up moved, capture it into the run's pool, and return the
        warm-up's cached memory."""
        kept = [t.clone() for t in _state(optimizer)]
        if state["pool"] is None and mesh is not None:
            # The communicator, set up by a collective outside any capture.
            dist.all_reduce(torch.zeros(1, device=device), group=mesh.group)
        if state["pool"] is None:
            # One side stream for every warm-up and capture of the run: an
            # allocation that outlives a window on a stream (tens of MB) pins
            # the segment it was cut from, once per stream.
            state["pool"], state["side"] = torch.cuda.graph_pool_handle(), torch.cuda.Stream()
        side = state["side"]
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            window(clips, labels, k)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if draws:
            graph.register_generator_state(generator)
        try:
            with torch.cuda.graph(graph, pool=state["pool"], stream=side):
                window(clips, labels, k)
        except RuntimeError as e:
            raise RuntimeError(f"capturing a {k}-step resident window "
                               f"(accumulation phase {phase}) failed: {e}") from e
        with torch.no_grad():
            for t, v in zip(_state(optimizer), kept, strict=True):
                t.copy_(v)
        del kept
        # The warm-up's blocks stay cached for the side stream, where no
        # replay allocates: give them back (a step's activations).
        torch.cuda.empty_cache()
        graphs[(k, phase)] = graph
        return graph

    def train_step(clips, labels):
        with data_group(mesh):
            return run(clips, labels)

    def run(clips, labels):
        if clips.device != device or labels.device != device:
            raise ValueError(f"resident clips on {clips.device} and labels on "
                             f"{labels.device}, the model on {device}")
        if mesh is not None and int(labels.shape[0]) != n_local:
            raise ValueError(f"{int(labels.shape[0])} resident clips on this rank, "
                             f"expected {n_local} ({n_clips} over {ranks})")
        count = state["count"]
        slot = count % steps_per_epoch
        k = min(fused, steps_per_epoch - slot)
        epoch = count // steps_per_epoch
        if epoch != state["epoch"]:
            perm.copy_(prng.epoch_permutation(seed, epoch, n_local, device, dev))
            state["epoch"] = epoch
        first.fill_(count)
        optimizer.stage(k)
        if device.type == "cuda":
            # The graphs read the tensors they were captured with.
            bound = state["bound"] or (clips, labels)
            if clips is not bound[0] or labels is not bound[1]:
                raise ValueError("the resident windows were captured over other "
                                 "clips and labels tensors")
            state["bound"] = bound
            phase = optimizer.mini_step
            graph = graphs.get((k, phase)) or capture(clips, labels, k, phase)
            graph.replay()
        else:
            window(clips, labels, k)
        optimizer.advance(k)
        state["count"] = count + k
        host = stats[:k].cpu().numpy().copy()  # one host fetch a window
        if fused == 1:
            return dict(zip(TRAIN_KEYS, host[0]))
        return dict(zip(TRAIN_KEYS, host.T))

    train_step.steps_per_epoch = steps_per_epoch
    train_step.fused_steps = fused
    train_step.windows_per_epoch = -(-steps_per_epoch // fused)
    train_step.graphs = graphs
    train_step.indices = indices
    return train_step


def _state(optimizer) -> list:
    """Every tensor a step updates in place: the parameters, Adam's moments
    and, where kept, the accumulated gradients and the EMA."""
    return [*optimizer.params, *optimizer.mu, *optimizer.nu,
            *(optimizer.acc or ()), *(optimizer.ema or ())]
