"""Training entry point — the reference mainclean.py flow
(pathtracker_tpu/train/loop.py), on one CUDA card.

    python -m pathtracker_torch.train --model InT --name InT --length 64 \\
        --speed 1 --dist 14 -b 180 --lr 3e-04 --epochs 2000 --parallel --bf16

Flow (reference mainclean.py:107-256): dataset_selector -> two
tfr_data_loaders -> model_selector -> hp_dict.npz snapshot -> BCEWithLogits
+ Adam -> epoch loop with per-batch train_step + meters + txt/npz sinks ->
per-epoch validate(logiters=3) -> EarlyStopping(patience=200)
checkpointing, plus the JAX package's rolling checkpoint with the optimizer
state, --auto-resume, a clean exit on SIGTERM and --profile. Checkpoints and
logs have the JAX package's names, layouts and formats, so each package
resumes and evaluates the other's runs.

The model runs on ``args.device`` (cuda where the namespace has none: the
command line has no such flag). --device-data keeps both splits on the
device and gathers the batches there (data/resident.py); with it,
--fused-steps K runs K steps a window, each window one CUDA graph on the
card; without it --fused-steps is ignored, as in the JAX package.

Data parallel (pathtracker_tpu/train/loop.py:222-228,256-319,496-518,
680-684): with COORDINATOR_ADDRESS set every process runs this same command,
joins the process group (parallel/distributed.py) on its own card and trains
under the data group (parallel/mesh.py): each rank reads a disjoint shard of
the input at batch / processes, BatchNorm, the gradient, the loss and the
meters are the global batch's, the weights and optimizer state start as
rank 0's, rank 0 alone writes the run folder, every rank stops at the same
step, and barriers align the ranks before and after the loop. ``python -m
pathtracker_torch.train --parallel`` on a host of k > 1 cards starts the k
processes itself (``launch``). --parallel on one card is one device, as the
JAX package's one-device mesh.
"""

from __future__ import annotations

import os
import shutil
import signal
import tempfile
import time
import warnings
import zipfile
from collections import deque
from contextlib import contextmanager
from statistics import mean

import numpy as np
import torch

from pathtracker_torch import engine, resolve_device
from pathtracker_torch.data.pipeline import tfr_data_loader
from pathtracker_torch.data.resident import (ResidentBatches, load_resident,
                                             make_resident_train_step)
from pathtracker_torch.parallel import distributed
from pathtracker_torch.parallel.mesh import data_group, make_mesh, replicate_tree
from pathtracker_torch.train import checkpoint as ckpt_lib
from pathtracker_torch.train.steps import (build_lr_schedule, ema_params,
                                           make_eval_step, make_optimizer,
                                           make_train_step)
from pathtracker_torch.train.torch_import import (import_video_resnet_state_dict,
                                                  jax_leaves, state_dict_from_jax,
                                                  to_jax_params)
from pathtracker_torch.utils.earlystopping import EarlyStopping
from pathtracker_torch.utils.meters import AverageMeter
from pathtracker_torch.utils.opts import parser

ROLLING = "model_last_epoch_checkpoint.pth.tar"


def device_prefetch(iterator, device, depth: int = 2):
    """Yield batches as tensors on ``device``, their copies issued ``depth``
    batches ahead so that they overlap the steps. On a CUDA device each
    batch is staged in pinned memory and copied without blocking; the
    pinned buffer is kept until its copy has completed."""
    device = torch.device(device)
    buf = deque()
    for item in iterator:
        host = tuple(torch.as_tensor(x) for x in item)
        done = None
        if device.type == "cuda":
            host = tuple(h.pin_memory() for h in host)
            moved = tuple(h.to(device, non_blocking=True) for h in host)
            done = torch.cuda.Event()
            done.record()
        else:
            moved = tuple(h.to(device) for h in host)
        buf.append((moved, host, done))
        if len(buf) > depth:
            yield _landed(buf.popleft())
    while buf:
        yield _landed(buf.popleft())


def _landed(entry):
    moved, _host, done = entry
    if done is not None:
        done.synchronize()  # only now may the pinned source be released
    return moved


def _trained(model) -> tuple[list[str], list[torch.Tensor]]:
    """(state_dict names, tensors) of the parameters the optimizer updates,
    in its order (make_train_step's)."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    return [n for n, _ in named], [p for _, p in named]


def _opt_state_extra(optimizer, names) -> dict:
    """The optimizer state as a checkpoint ``extra`` payload, in the layout
    of the JAX package's optax state (``Optimizer.state_dict``). The rolling
    checkpoint carries it so --auto-resume continues Adam's moments and
    count and any EMA exactly; best-val checkpoints stay params-only (the
    eval and export format)."""
    return {"opt_state": optimizer.state_dict(names)}


def _state_copy(model) -> dict:
    """The model's weights now, as CPU tensors: the step updates the
    parameters in place."""
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


def save_npz(log_dict: dict, results_folder: str, savename: str = "train") -> None:
    """train.npz / val.npz observability sinks (reference mainclean.py:101-104)."""
    with open(os.path.join(results_folder, savename + ".npz"), "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in log_dict.items()})


def _load_npz_logs(log_dict: dict, results_folder: str, savename: str,
                   max_entries: int | None = None) -> None:
    """Preload a previous run's train/val npz into the in-memory log dict
    (auto-resume path) so sliced campaigns accumulate one continuous curve
    instead of overwriting with the latest slice only."""
    path = os.path.join(results_folder, savename + ".npz")
    if not os.path.exists(path):
        return
    try:
        with np.load(path) as prior:
            for k in log_dict:
                if k in prior.files:
                    vals = prior[k].tolist()
                    if max_entries is not None:
                        vals = vals[:max_entries]
                    log_dict[k].extend(vals)
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        print(f"auto-resume: could not preload {savename}.npz ({e}); "
              f"curves restart from this slice")


def results_folder_for(args) -> str:
    """A run's folder, {results_dir}/{length}_{speed}_{dist}[_flow]/{name}."""
    stem = f"{args.length}_{args.speed}_{args.dist}"
    if args.optical_flow:
        stem = f"{stem}_flow"
    return os.path.join(args.results_dir, stem, str(args.name))


def init_model(args, timesteps: int, device=None, **model_kwargs):
    """The model with the run seed's init, on ``device`` (by default
    ``args.device``, cuda where the namespace has none), pretrained weights
    applied under ``--pretrained``; ``model_kwargs`` reach its constructor."""
    model = engine.model_selector(args, timesteps=timesteps,
                                  device=device or getattr(args, "device", None),
                                  **{"seed": args.seed, **model_kwargs})
    if getattr(args, "pretrained", False):
        load_pretrained(model, args.model)
    return model


# --model name -> torchvision checkpoint filename (reference
# nostridetv.py:12-16 model_urls; a locally provided copy is read from
# $PATHTRACKER_PRETRAINED_DIR, nothing is fetched).
_PRETRAINED_FILES = {
    "r3d": "r3d_18_fc_rm1.pth",
    "mc3": "mc3_18_fc_rm1.pth",
    "r2plus1": "r2plus1d_18_fc_rm1.pth",
}
_PRETRAINED_ALIASES = {
    "r3d": ("r3d_18.pth",),
    "mc3": ("mc3_18.pth",),
    "r2plus1": ("r2plus1d_18.pth",),
}


def load_pretrained(model, model_name: str):
    """--pretrained: look for a locally provided torchvision video
    checkpoint under $PATHTRACKER_PRETRAINED_DIR (default ./pretrained) and
    import it into ``model`` in place (pathtracker_tpu/train/loop.py:138-175):
    BN running statistics dropped, the Kinetics 400-class head skipped.
    Without a file, keep the initialized weights with a warning. The
    narrowed no-stride forks cannot take Kinetics weights (their widths
    differ), so they, like every other model, warn and keep their init."""
    names = _PRETRAINED_FILES.get(model_name)
    if names is None:
        warnings.warn(
            f"--pretrained: {model_name!r} has no torchvision checkpoint "
            "counterpart (narrowed trunks); using the pretrained input "
            "normalization only.", stacklevel=2)
        return model
    root = os.environ.get("PATHTRACKER_PRETRAINED_DIR",
                          os.path.abspath("pretrained"))
    candidates = [os.path.join(root, names)] + [
        os.path.join(root, a) for a in _PRETRAINED_ALIASES.get(model_name, ())]
    path = next((p for p in candidates if os.path.exists(p)), None)
    if path is None:
        warnings.warn(
            "--pretrained: no local torchvision checkpoint found (looked for "
            f"{candidates}); using the pretrained input normalization only. "
            "Place the torchvision .pth there to load real weights.",
            stacklevel=2)
        return model
    state = ckpt_lib.load_checkpoint(path)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    print(f"Loading pretrained torchvision weights from {path}")
    params = import_video_resnet_state_dict(
        state, to_jax_params(model.state_dict()), strict=False)
    model.load_state_dict(state_dict_from_jax(model_name, params))
    return model


def validate(val_loader, eval_step, args, results_folder, len_val_loader,
             logiters=None):
    """Validation loop (reference mainclean.py:54-98): the eval step over
    the loader's batches, all of them with a log line every --print-freq,
    or, with ``logiters``, up to batch ``logiters + 1`` and no lines."""
    meters = {k: AverageMeter() for k in
              ("loss", "balacc", "precision", "recall", "f1score", "batch_time")}
    end = time.time()
    for i, (imgs, target) in enumerate(_together(val_loader)):
        stats = eval_step(imgs, target)
        meters["loss"].update(float(stats["loss"]), 1)
        meters["balacc"].update(float(stats["balacc"]), 1)
        meters["precision"].update(float(stats["precision"]), 1)
        meters["recall"].update(float(stats["recall"]), 1)
        meters["f1score"].update(float(stats["f1score"]), 1)
        meters["batch_time"].update(time.time() - end)
        end = time.time()
        if logiters is None:
            if i % args.print_freq == 0:
                line = (f"Test: [{i * args.batch_size}/{len_val_loader}]\t "
                        f"Time: {meters['batch_time'].avg:.3f}\t "
                        f"Loss: {meters['loss'].val:.8f} ({meters['loss'].avg:.8f})\t "
                        f"Bal_acc: {meters['balacc'].avg:.8f} "
                        f"preci: {meters['precision'].avg:.5f} "
                        f"rec: {meters['recall'].avg:.5f} f1: {meters['f1score'].avg:.5f}")
                print(line)
                with open(os.path.join(results_folder, args.name + ".txt"), "a+") as f:
                    f.write(line + "\n")
        elif i > logiters:
            break
    m = meters
    return (m["balacc"].avg, m["precision"].avg, m["recall"].avg,
            m["f1score"].avg, m["loss"].avg)


def _together(iterable, stop=lambda: False):
    """The items of ``iterable`` while every rank of the process group has
    one and none asks to ``stop()``: one collective of the two flags a
    round, so a rank whose shard ends first, or which caught a SIGTERM,
    stops its peers at the same batch instead of leaving them in a
    collective it never enters. One process: the items until it ends or
    stops."""
    it = iter(iterable)
    while True:
        item = next(it, None)
        ended, stopped = distributed.any_rank([item is None, stop()])
        if ended or stopped:
            return
        yield item


@contextmanager
def _weights(params, values):
    """Run the body with ``values`` copied into ``params``, then restore."""
    if values is None:
        yield
        return
    with torch.no_grad():
        saved = [p.clone() for p in params]
        for p, v in zip(params, values, strict=True):
            p.copy_(v)
    try:
        yield
    finally:
        with torch.no_grad():
            for p, v in zip(params, saved, strict=True):
                p.copy_(v)


def _refuse_later_slices(args, device, mesh=None) -> None:
    """Flag combinations the port does not run raise before anything is
    loaded or written."""
    rbp = "rbp" in getattr(args, "algo", "bptt")
    if rbp and (getattr(args, "device_data", False) or getattr(args, "fused_steps", 1) > 1):
        # Each Neumann term's exit test reads a norm back to the host
        # (ops/rbp.py): RBP steps run one by one, outside CUDA graphs.
        raise ValueError("--algo rbp runs neither --device-data nor --fused-steps: "
                         "its backward syncs with the host every Neumann term")
    if rbp and mesh is not None:
        # The exit test reads this rank's norm: ranks would take different
        # numbers of terms, each with its own collectives, and wait forever.
        raise ValueError("--algo rbp does not train data-parallel: each Neumann "
                         "term's exit test reads one rank's norm back to the host")
    if (mesh is not None and getattr(args, "device_data", False) and device.type == "cuda"
            and torch.distributed.get_backend() != "nccl"):
        raise ValueError("--device-data on the card runs each window as a CUDA graph, "
                         f"which cannot hold {torch.distributed.get_backend()}'s "
                         "collectives: train over NCCL, or without --device-data")
    if (args.parallel and mesh is None and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        raise ValueError(
            f"--parallel over {torch.cuda.device_count()} cards runs one process a "
            "card: start them with python -m pathtracker_torch.train (launch), or "
            "set COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID in each")


def main(args=None, max_steps_per_epoch: int | None = None,
         model_kwargs: dict | None = None):
    """Train as the reference's mainclean.py does; ``max_steps_per_epoch``
    caps the optimizer steps of each epoch, and ``model_kwargs`` reach the
    model's constructor (e.g. ``fused=False``: InT's eager cell). Returns
    the JAX package's dict — the final weights (here the model's
    ``state_dict``), the results folder, the logs, whether it stopped
    early — and the last epoch's train meters (``batch_time`` and
    ``data_time`` among them)."""
    if args is None:
        args = parser.parse_args()
    opened = False
    if os.environ.get("COORDINATOR_ADDRESS") and not distributed.is_initialized():
        # A multi-process launch: every process runs this command with
        # COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID set, and joins the
        # group before any device use.
        distributed.initialize(device=getattr(args, "device", None))
        opened = True
    try:
        return _main(args, max_steps_per_epoch, model_kwargs or {})
    finally:
        if opened:
            distributed.shutdown()


def _main(args, max_steps_per_epoch, model_kwargs):
    if distributed.is_initialized():
        device, mesh = distributed.device(), make_mesh()
    else:
        device, mesh = resolve_device(getattr(args, "device", None)), None
    _refuse_later_slices(args, device, mesh)
    with data_group(mesh):
        return _train(args, max_steps_per_epoch, device, mesh, model_kwargs)


def _train(args, max_steps_per_epoch, device, mesh, model_kwargs):
    ranks, rank, primary = ((1, 0, True) if mesh is None
                            else (mesh.size, mesh.rank, distributed.is_primary()))
    assert args.dist is not None, "You must pass a PT distance."
    assert args.speed is not None, "You must pass a PT speed."
    assert args.length is not None, "You must pass a PT length."
    disentangle_channels = False

    pf_root, timesteps, len_train_loader, len_val_loader = engine.dataset_selector(
        dist=args.dist, speed=args.speed, length=args.length,
        optical_flow=args.optical_flow,
        synth_train=args.synth_train, synth_test=args.synth_test)
    device_data = getattr(args, "device_data", False)
    # Each rank takes batch / ranks clips a step (the JAX package's
    # per-process batch); one rank, the whole batch.
    local_batch = max(1, args.batch_size // ranks)
    if device_data:
        print("Loading training dataset (device-resident)")
        train_clips, train_labels = _resident_split(pf_root + "train-*", args, device, mesh)
        print("Loading validation dataset (device-resident)")
        val_clips, val_labels = _resident_split(pf_root + "test-*", args, device, mesh)
        train_loader = None
        val_loader = ResidentBatches(val_clips, val_labels, local_batch,
                                     shuffle=True, seed=args.seed)
        # The global counts, trimmed to a multiple of the ranks.
        len_train_loader = int(train_labels.shape[0]) * ranks
        len_val_loader = int(val_labels.shape[0]) * ranks
    else:
        print("Loading training dataset")
        train_loader = tfr_data_loader(
            data_dir=pf_root + "train-*", batch_size=local_batch,
            drop_remainder=True, timesteps=args.length, seed=args.seed,
            shard_index=rank, shard_count=ranks)
        print("Loading validation dataset")
        val_loader = tfr_data_loader(
            data_dir=pf_root + "test-*", batch_size=local_batch,
            drop_remainder=True, timesteps=args.length, seed=args.seed,
            shard_index=rank, shard_count=ranks)
        if ranks > 1:
            # Each rank's input: a disjoint file slice where there are at
            # least as many files as ranks, else every file with records
            # strided (data/pipeline.py::ClipDataset).
            print(f"input shard: rank {rank}/{ranks} files={len(train_loader.files)} "
                  f"record_stride={train_loader._record_stride}")

    results_folder, scratch = results_folder_for(args), None
    if not primary:
        # Rank 0 alone writes the run folder (every rank computes the same
        # global metrics); the others run the same flow into a throwaway one.
        scratch = tempfile.mkdtemp(prefix="pt_rank{}_".format(rank))
        results_folder = os.path.join(scratch, "results")
    os.makedirs(results_folder, exist_ok=True)
    ES = EarlyStopping(patience=200, results_folder=results_folder)

    model = init_model(args, timesteps, device, **model_kwargs)
    names, params = _trained(model)
    print(sum(p.numel() for p in model.parameters()))
    if args.parallel:
        print("Loading parallel finished on device count:", ranks)
    else:
        print("Loading finished")

    # hp_dict.npz snapshot (reference mainclean.py:140-155); parameter names
    # and shapes as the JAX package lists its params.
    hp_dict = {
        "penalty": args.penalty,
        "start_epoch": args.start_epoch,
        "epochs": args.epochs,
        "lr": args.lr,
        "lr_schedule": getattr(args, "lr_schedule", "none"),
        "clip_grad": str(getattr(args, "clip_grad", None)),
        "accum_steps": getattr(args, "accum_steps", 1),
        "ema": str(getattr(args, "ema", None)),
        "loaded_ckpt": str(args.ckpt),
        "results_dir": results_folder,
        "exp_name": args.name,
        "algo": args.algo,
        "dimensions": args.dimensions,
        "fb_kernel_size": args.fb_kernel_size,
        "timesteps": timesteps,
        "param_names_shapes": np.asarray(
            [f"{path}:{np.shape(v)}"
             for path, v in jax_leaves(to_jax_params(model.state_dict()))]),
    }
    np.savez(os.path.join(results_folder, "hp_dict"), **hp_dict)

    ema_decay = getattr(args, "ema", None)
    if args.ckpt is not None:
        engine.load_ckpt(model, args.ckpt)
    resume_opt_sd = None
    if getattr(args, "auto_resume", False):
        # If this run's folder has the rolling checkpoint (written every epoch
        # and on SIGTERM), continue from it: weights, start epoch and the
        # optimizer state. An explicit --ckpt applies first (warm start), then
        # the rolling state supersedes it.
        rolling = os.path.join(results_folder, "saved_models", ROLLING)
        if os.path.exists(rolling):
            state = ckpt_lib.load_checkpoint(rolling)
            engine.load_ckpt(model, rolling)
            resume_epoch = int(state.get("epoch", 0)) + 1
            if resume_epoch > args.start_epoch:
                args.start_epoch = resume_epoch
            resume_opt_sd = (state.get("extra") or {}).get("opt_state")
            print(f"auto-resume: rolling checkpoint found, continuing from "
                  f"epoch {args.start_epoch}")
    # An lr schedule is indexed by Adam's step count. A restored count
    # already indexes it; with fresh moments (a --ckpt restart, or a rolling
    # checkpoint without optimizer state) the schedule is offset by the
    # resumed epoch so the decay continues where the previous run stopped.
    accum = max(1, getattr(args, "accum_steps", 1))
    opt_steps_per_epoch = max(1, (len_train_loader // args.batch_size) // accum)
    resume_offset = args.start_epoch * opt_steps_per_epoch

    def _make_opt(start_step: int):
        sched = build_lr_schedule(
            getattr(args, "lr_schedule", "none"), args.lr, opt_steps_per_epoch,
            args.epochs, lr_steps=args.lr_steps,
            warmup_epochs=getattr(args, "warmup_epochs", 0.0),
            start_step=start_step)
        opt = make_optimizer(args.lr, clip_grad=getattr(args, "clip_grad", None),
                             accum_steps=accum, ema=ema_decay, schedule=sched)
        return sched, opt.init(params)

    schedule, optimizer = _make_opt(0 if resume_opt_sd is not None else resume_offset)
    opt_restored = False
    if resume_opt_sd is not None:
        try:
            optimizer.load_state_dict(resume_opt_sd, names, args.model)
            opt_restored = True
            print("auto-resume: optimizer state restored "
                  "(Adam moments/count continue)")
        except (ValueError, KeyError, TypeError) as e:
            # Other --clip-grad/--accum-steps/--ema/--lr-schedule flags than
            # the saved run's reshape the state: fresh moments, offset schedule.
            print(f"auto-resume: saved optimizer state incompatible with the "
                  f"current flags ({e}); starting with fresh moments")
            schedule, optimizer = _make_opt(resume_offset)
    if mesh is not None:
        # Every rank starts from rank 0's state: its --ckpt, and the rolling
        # checkpoint of its run folder, the only real one.
        args.start_epoch, opt_restored, counts = distributed.broadcast_object(
            (args.start_epoch, opt_restored, (optimizer.count, optimizer.mini_step)))
        resume_offset = args.start_epoch * opt_steps_per_epoch
        if not primary:
            schedule, optimizer = _make_opt(0 if opt_restored else resume_offset)
        optimizer.count, optimizer.mini_step = counts
        replicate_tree(mesh, [*model.state_dict().values(), *optimizer.params,
                              *optimizer.mu, *optimizer.nu, *(optimizer.acc or ()),
                              *(optimizer.ema or ())])

    prep = {"disentangle_channels": disentangle_channels,
            "pretrained_norm": args.pretrained,
            "coord_channels": engine.needs_coord_channels(args.model)}
    if device_data:
        train_step = make_resident_train_step(
            model, args.model, optimizer, n_clips=len_train_loader,
            batch_size=local_batch * ranks, penalty=args.penalty,
            prepare_kwargs=prep, seed=args.seed,
            fused_steps=getattr(args, "fused_steps", 1), mesh=mesh)
    else:
        train_step = make_train_step(model, args.model, optimizer,
                                     penalty=args.penalty, prepare_kwargs=prep,
                                     seed=args.seed)
    eval_step = make_eval_step(model, args.model, prepare_kwargs=prep)

    val_log_dict = {"loss": [], "balacc": [], "precision": [], "recall": [],
                    "f1score": []}
    train_log_dict = {"loss": [], "balacc": [], "precision": [], "recall": [],
                      "f1score": [], "jvpen": [], "scaled_loss": []}
    if args.start_epoch > 0 and getattr(args, "auto_resume", False):
        # Keep the curves cumulative across relaunches; val keeps one entry
        # per completed epoch so epoch indexing stays exact.
        _load_npz_logs(train_log_dict, results_folder, "train")
        _load_npz_logs(val_log_dict, results_folder, "val",
                       max_entries=args.start_epoch)

    stop = False
    # Optimizer steps for the log line's lr: with restored state Adam's
    # count continues, so does this counter; otherwise the schedule carries
    # the offset and the counter starts at 0.
    opt_steps_done = float(resume_offset) if opt_restored else 0.0
    profiler, meters = None, {}

    # The first SIGTERM finishes the current step, saves the rolling
    # checkpoint and the logs, and returns; a second one kills.
    terminated = {"flag": False}

    def _on_sigterm(signum, frame):
        terminated["flag"] = True
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        print("SIGTERM: finishing step, checkpointing, exiting cleanly "
              "(send again to kill)", flush=True)

    try:
        prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # not the main thread (e.g. driven from a test runner)
        prev_sigterm = None

    def save_rolling(epoch):
        os.makedirs(os.path.join(results_folder, "saved_models"), exist_ok=True)
        path = os.path.join(results_folder, "saved_models", ROLLING)
        ckpt_lib.save_checkpoint(path, _state_copy(model), epoch=epoch,
                                 extra=_opt_state_extra(optimizer, names))
        return path

    # Align every rank before the first collective: loading skews them.
    distributed.barrier("pre-train-loop")
    for epoch in range(args.start_epoch, args.epochs):
        meters = {k: AverageMeter() for k in
                  ("batch_time", "data_time", "loss", "balacc", "precision",
                   "recall", "f1score")}
        time_since_last = time.time()
        end = time.perf_counter()
        if device_data:
            # The step gathers its own batches; with --fused-steps each
            # iteration is a window of steps with one stats fetch.
            batches = ((train_clips, train_labels)
                       for _ in range(train_step.windows_per_epoch))
        else:
            batches = device_prefetch(iter(train_loader), device)
        steps_done = 0  # optimizer steps (a window advances by its length)
        # A SIGTERM on any rank stops every rank before the same step.
        for idx, (imgs, target) in enumerate(_together(batches,
                                                       lambda: terminated["flag"])):
            meters["data_time"].update(time.perf_counter() - end)
            # Trace steps (windows) 1-4 of the first epoch (0 warms up).
            if args.profile and primary and epoch == args.start_epoch and idx == 1:
                profiler = _start_profiler(device)
            stats = train_step(imgs, target)
            if profiler is not None and idx >= 4:
                profiler = _stop_profiler(profiler, args.profile)
            # A window's stats are [k] arrays, a plain step's scalars.
            sub = {k: np.atleast_1d(v) for k, v in stats.items()}
            n_sub = len(sub["loss"])
            for s in range(n_sub):
                meters["loss"].update(float(sub["loss"][s]), 1)
                train_log_dict["jvpen"].append(float(sub["jvpen"][s]))
                train_log_dict["scaled_loss"].append(float(sub["scaled_loss"][s]))
                meters["balacc"].update(float(sub["balacc"][s]), 1)
                meters["precision"].update(float(sub["precision"][s]), 1)
                meters["recall"].update(float(sub["recall"][s]), 1)
                meters["f1score"].update(float(sub["f1score"][s]), 1)
            # batch_time stays a step's time under fusion.
            meters["batch_time"].update((time.perf_counter() - end) / n_sub)
            end = time.perf_counter()
            opt_steps_done += n_sub / accum

            if idx % args.print_freq == 0:
                time_now = time.time()
                pf = max(args.print_freq, 1)
                # The lr the most recent optimizer step applied.
                lr_now = (args.lr if schedule is None
                          else float(schedule(max(0, int(opt_steps_done) - 1))))
                line = (
                    f"Epoch: [{epoch}][{idx}/{len_train_loader}]  lr: {lr_now:g}  "
                    f"Time: {meters['batch_time'].val:.3f} "
                    f"(itavg:{mean(meters['batch_time'].history[-pf:]):.3f}) "
                    f"({meters['batch_time'].avg:.3f})  "
                    f"Data: {meters['data_time'].val:.3f} ({meters['data_time'].avg:.3f}) "
                    f"Loss: {meters['loss'].val:.8f} "
                    f"({mean(meters['loss'].history[-pf:]):.8f}) "
                    f"({meters['loss'].avg:.8f})  "
                    f"bal_acc: {meters['balacc'].val:.5f} ({meters['balacc'].avg:.5f}) "
                    f"preci: {meters['precision'].val:.5f} ({meters['precision'].avg:.5f}) "
                    f"rec: {meters['recall'].val:.5f} ({meters['recall'].avg:.5f})  "
                    f"f1: {meters['f1score'].val:.5f} ({meters['f1score'].avg:.5f}) "
                    f"jvpen: {train_log_dict['jvpen'][-1]:.12f} "
                    f"{time_now - time_since_last:.3f}")
                print(line, flush=True)
                time_since_last = time_now
                with open(os.path.join(results_folder, args.name + ".txt"), "a+") as f:
                    f.write(line + "\n")
            # The cap counts optimizer steps, not windows.
            steps_done += n_sub
            if max_steps_per_epoch is not None and steps_done >= max_steps_per_epoch:
                break
            if terminated["flag"] and mesh is None:
                break

        if profiler is not None:  # epoch shorter than the trace window
            profiler = _stop_profiler(profiler, args.profile)
        terminated["flag"] = distributed.any_rank([terminated["flag"]])[0]

        train_log_dict["loss"].extend(meters["loss"].history)
        train_log_dict["balacc"].extend(meters["balacc"].history)
        train_log_dict["precision"].extend(meters["precision"].history)
        train_log_dict["recall"].extend(meters["recall"].history)
        train_log_dict["f1score"].extend(meters["f1score"].history)
        save_npz(train_log_dict, results_folder, "train")
        save_npz(val_log_dict, results_folder, "val")

        if terminated["flag"]:
            last = save_rolling(epoch)
            print(f"terminated: logs + rolling checkpoint saved mid-epoch "
                  f"{epoch}; resume with --ckpt {last} --start-epoch {epoch}",
                  flush=True)
            stop = True
            break

        # With --ema, validation and best-val checkpoints use the averaged
        # weights; the rolling checkpoint keeps the raw weights so a resume
        # continues the exact trajectory.
        ema = ema_params(optimizer) if ema_decay is not None else None
        with _weights(params, ema):
            accv, precv, recv, f1sv, losv = validate(
                val_loader, eval_step, args, results_folder, len_val_loader,
                logiters=3)
            eval_state = _state_copy(model)
        line = f"val f {f1sv} val loss {losv}"
        print(line, flush=True)
        val_log_dict["loss"].append(losv)
        val_log_dict["balacc"].append(accv)
        val_log_dict["precision"].append(precv)
        val_log_dict["recall"].append(recv)
        val_log_dict["f1score"].append(f1sv)
        with open(os.path.join(results_folder, args.name + ".txt"), "a+") as f:
            f.write(line + "\n")
        save_npz(val_log_dict, results_folder, "val")
        # The rolling last-epoch checkpoint (one file, overwritten): the
        # reference saves only on a val-accuracy improvement, which leaves
        # nothing recoverable when a long run later destabilizes. Eval's
        # best-checkpoint selection ignores this file by name.
        save_rolling(epoch)
        ES(accv, eval_state, epoch)
        if distributed.any_rank([ES.early_stop])[0]:
            print("Early stopping triggered. Quitting.")
            stop = True
            break
    if prev_sigterm is not None:
        try:
            signal.signal(signal.SIGTERM, prev_sigterm)
        except (ValueError, TypeError):
            pass
    try:
        # Rank 0 writes its last artifacts after the last collective.
        distributed.barrier("post-train-loop", timeout_s=120)
    except RuntimeError as e:
        print(f"post-train-loop barrier failed ({e}); a peer rank likely exited "
              "abnormally", flush=True)
    if scratch is not None:
        shutil.rmtree(scratch, ignore_errors=True)
        results_folder = None
    return {"params": model.state_dict(), "results_folder": results_folder,
            "val_log": val_log_dict, "train_log": train_log_dict,
            "early_stopped": stop, "meters": meters}


def _resident_split(pattern: str, args, device, mesh):
    """A split on the device: the whole of it on one rank; over a mesh this
    rank's slice, in rank order, of the clips trimmed to a multiple of the
    ranks (the JAX package's batch sharding of the resident arrays)."""
    if mesh is None:
        return load_resident(pattern, timesteps=args.length, device=device)
    clips, labels = load_resident(pattern, timesteps=args.length, device="cpu")
    n = int(labels.shape[0]) // mesh.size
    lo = mesh.rank * n
    return clips[lo:lo + n].to(device), labels[lo:lo + n].to(device)


def launch(args, cards: int) -> None:
    """Train ``args`` data-parallel over ``cards`` cards of this host, one
    process each (the JAX package drives every local device from one
    process): the processes meet through a file in a temporary folder, and a
    failure in any of them ends all and raises here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="pt_launch_") as tmp:
        address = "file://" + os.path.join(tmp, "rendezvous")
        mp.start_processes(_launched, args=(args, address, cards), nprocs=cards,
                           start_method="spawn")


def _launched(rank: int, args, address: str, world: int) -> None:
    os.environ.update(COORDINATOR_ADDRESS=address, NUM_PROCESSES=str(world),
                      PROCESS_ID=str(rank), LOCAL_RANK=str(rank))
    main(args)


def _start_profiler(device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, folder: str) -> None:
    prof.stop()
    os.makedirs(folder, exist_ok=True)
    prof.export_chrome_trace(os.path.join(folder, "trace.json"))
    print(f"profiler trace written to {folder}")
    return None


if __name__ == "__main__":
    main()
