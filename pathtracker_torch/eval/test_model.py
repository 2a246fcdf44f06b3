"""Generalization evaluation: the reference test_model.py flow
(pathtracker_tpu/eval/test_model.py).

``eval_best_model`` picks the best checkpoint of a run (val.npz balacc
argmax over the mtime-sorted saved_models/*.tar, reference
test_model.py:59-64) and evaluates it over the 8 (dist, speed, length)
configs; ``evaluate_model`` runs one config and writes
test_perf_dist_{d}_speed_{s}_length_{l}.npz with (mean acc, mean loss) as
``arr_0`` and ``arr_1`` and, for recurrent models, the Img/Attn/Activity
plots and GIFs (where matplotlib and imageio are installed; elsewhere a
warning says they are skipped). The reference's ``--which_tests=64`` flag (test_InT.sh:3,
never defined in its opts) filters the sweep by clip length.

    python -m pathtracker_torch.eval.test_model --model InT --name chainE \\
        --length 64 --speed 1 --dist 14 -b 128 --bf16 --ckpt <checkpoint>

The model runs on ``args.device`` (cuda where the namespace has none: the
command line has no such flag). ``eval_batch`` is one batch of the loop; a
script drives it over loaders of its own through ``evaluate_batches``.
"""

from __future__ import annotations

import importlib.util
import os
import time
import warnings
from types import SimpleNamespace

import numpy as np
import torch

from pathtracker_torch import engine
from pathtracker_torch.data.pipeline import tfr_data_loader
from pathtracker_torch.data.prepare import prepare_batch
from pathtracker_torch.train import checkpoint as ckpt_lib
from pathtracker_torch.utils.metrics import bce_with_logits, eval_accuracy
from pathtracker_torch.utils.opts import parser

# Status-code classes of a transient backend failure (a stalled or
# preempted device client) rather than a bug in the eval: the eval retries
# those once.
_TRANSIENT_MARKERS = ("FAILED_PRECONDITION", "DEADLINE_EXCEEDED",
                      "UNAVAILABLE", "ABORTED", "RESOURCE_EXHAUSTED: Attempting")


def _is_transient_backend_error(e: Exception) -> bool:
    msg = f"{type(e).__name__}: {e}"
    return any(m in msg for m in _TRANSIENT_MARKERS)


def _prune_empty_results_dir(results_folder: str) -> None:
    """Never leave an empty results/<name>/ behind on a failed eval: an
    empty dir reads as 'eval ran, produced nothing'."""
    try:
        if os.path.isdir(results_folder) and not os.listdir(results_folder):
            os.rmdir(results_folder)
    except OSError:
        pass


def evaluate_model_with_retry(results_folder, args, prep_gifs=3, dist=14,
                              speed=1, length=64, retries=1,
                              backoff_s=None, _eval_fn=None):
    """``evaluate_model`` with ``retries`` self-retries on transient backend
    errors, each after ``backoff_s`` seconds (default
    ``$PATHTRACKER_EVAL_RETRY_BACKOFF_S`` or 90). Other errors propagate at
    once; a failed final attempt removes an empty results dir first."""
    if backoff_s is None:
        backoff_s = float(os.environ.get("PATHTRACKER_EVAL_RETRY_BACKOFF_S", 90))
    fn = _eval_fn or evaluate_model
    attempt = 0
    while True:
        try:
            return fn(results_folder, args, prep_gifs=prep_gifs, dist=dist,
                      speed=speed, length=length)
        except Exception as e:  # noqa: BLE001 — classified below
            if not _is_transient_backend_error(e) or attempt >= retries:
                _prune_empty_results_dir(results_folder)
                raise
            attempt += 1
            print(f"eval: transient backend error "
                  f"({type(e).__name__}: {str(e)[:200]}); retry "
                  f"{attempt}/{retries} after {backoff_s:.0f}s backoff")
            time.sleep(backoff_s)


def eval_batch(model, model_name: str, raw_imgs, raw_labels,
               prepare_kwargs: dict | None = None):
    """One eval batch (reference test_model.py:112-129): uint8 [B,T,H,W,3]
    clips and [B] byte labels (numpy or tensors) -> (output, states, gates,
    loss, acc, imgs, target) on the model's device, from the forward with
    ``test=True`` (states and gates are what the plots draw)."""
    device = next(model.parameters()).device
    raw_imgs = torch.as_tensor(raw_imgs).to(device, non_blocking=True)
    raw_labels = torch.as_tensor(raw_labels).to(device, non_blocking=True)
    imgs, target = prepare_batch(raw_imgs, raw_labels, **(prepare_kwargs or {}))
    output, states, gates = engine.model_step(model, imgs, model_name, test=True)
    loss = bce_with_logits(output, target)
    acc = eval_accuracy(target, output)
    return output, states, gates, loss, acc, imgs, target


def evaluate_batches(model, model_name: str, loader,
                     prepare_kwargs: dict | None = None):
    """``eval_batch`` over every batch of ``loader`` in inference mode;
    (per-batch accuracies, per-batch losses, the last batch's
    ``eval_batch`` result or None)."""
    accs, losses, last = [], [], None
    with torch.inference_mode():
        for raw_imgs, raw_labels in loader:
            last = eval_batch(model, model_name, raw_imgs, raw_labels,
                              prepare_kwargs)
            accs.append(float(last[4]))
            losses.append(float(last[3]))
    return accs, losses, last


def _can_plot() -> bool:
    return all(importlib.util.find_spec(m) is not None
               for m in ("matplotlib", "imageio"))


def evaluate_model(results_folder, args, prep_gifs=3, dist=14, speed=1, length=64):
    """Evaluate one (dist, speed, length) config (reference test_model.py:78-139)."""
    os.makedirs(results_folder, exist_ok=True)

    pf_root, timesteps, len_train_loader, len_val_loader = engine.dataset_selector(
        dist=dist, speed=speed, length=length)
    print("Loading validation dataset")
    val_loader = tfr_data_loader(
        data_dir=os.path.join(pf_root, "test-*"), batch_size=args.batch_size,
        drop_remainder=True, timesteps=timesteps)

    model = engine.model_selector(args, timesteps,
                                  device=getattr(args, "device", None))
    print(sum(p.numel() for p in model.parameters()))

    assert args.ckpt is not None, "You must pass a checkpoint for testing."
    engine.load_ckpt(model, args.ckpt)
    model.eval()

    prep = {"pretrained_norm": getattr(args, "pretrained", False),
            "coord_channels": engine.needs_coord_channels(args.model)}
    accs, losses, last = evaluate_batches(model, args.model, val_loader, prep)

    print(f"Mean accuracy: {np.mean(accs)}, mean loss: {np.mean(losses)}")
    np.savez(os.path.join(results_folder,
                          f"test_perf_dist_{dist}_speed_{speed}_length_{length}"),
             np.mean(accs), np.mean(losses))

    recurrent = engine.family(args.model) == "recurrent"
    if recurrent and last is not None and prep_gifs and not _can_plot():
        warnings.warn("matplotlib or imageio is not installed: the plots and GIFs "
                      "are skipped", stacklevel=2)
    elif recurrent and last is not None and prep_gifs:
        output, states, gates, _, _, imgs, target = last
        data_results_folder = os.path.join(
            results_folder, f"test_dist_{dist}_speed_{speed}_length_{length}")
        os.makedirs(data_results_folder, exist_ok=True)
        engine.plot_results(states, imgs, target, output=output,
                            timesteps=timesteps, gates=gates, prep_gifs=prep_gifs,
                            results_folder=data_results_folder)
    return float(np.mean(accs)), float(np.mean(losses))


def eval_best_model(directory, model, prep_gifs=3, batch_size=100,
                    which_tests=None, results_folder=None):
    """Find the best checkpoint in ``directory`` and evaluate it on all
    configs (reference test_model.py:52-75)."""
    args = SimpleNamespace()
    args.batch_size = batch_size
    args.parallel = True
    args.ckpt = ckpt_lib.find_best_checkpoint(directory)
    args.model = model
    args.penalty = "Testing"
    args.algo = "Testing"
    args.dimensions = 32
    args.fb_kernel_size = 7
    args.seed = 0
    args.pretrained = "imagenet" in directory
    results = {}
    for d in engine.get_datasets():
        if which_tests is not None and str(d["length"]) != str(which_tests):
            continue
        key = (d["dist"], d["speed"], d["length"])
        results[key] = evaluate_model_with_retry(
            results_folder or directory, args, prep_gifs=prep_gifs,
            dist=d["dist"], speed=d["speed"], length=d["length"])
    return results


def _run_folder(args) -> str:
    """A training run's folder, results/{length}_{speed}_{dist}[_flow]/{name}
    (pathtracker_tpu/train/loop.py:98-102)."""
    stem = f"{args.length}_{args.speed}_{args.dist}"
    if args.optical_flow:
        stem = f"{stem}_flow"
    return os.path.join(args.results_dir, stem, str(args.name))


def main(args=None):
    if args is None:
        args = parser.parse_args()
    results_folder = os.path.join("results", str(args.name))
    if args.ckpt is None:
        # Training runs write under results/{length}_{speed}_{dist}/{name};
        # either layout is accepted.
        candidates = [results_folder]
        if args.length is not None:
            candidates.insert(0, _run_folder(args))
        directory = next((c for c in candidates
                          if os.path.exists(os.path.join(c, "val.npz"))), None)
        if directory is None:
            raise FileNotFoundError(
                f"no val.npz under any of {candidates}; pass --ckpt explicitly")
        return eval_best_model(directory=directory, model=args.model,
                               which_tests=args.which_tests)
    return evaluate_model_with_retry(
        results_folder=results_folder, args=args,
        dist=args.dist if args.dist is not None else 14,
        speed=args.speed if args.speed is not None else 1,
        length=args.length if args.length is not None else 64)


if __name__ == "__main__":
    main()
