#!/usr/bin/env python3
"""The 8-config generalization sweep of one pinned checkpoint with
pathtracker_torch (scripts/eval_matrix.py).

    python3 scripts/torch_eval_matrix.py <ckpt> [results_folder] [model]

Evaluates ``ckpt`` over the reference's 8 ALL_DATASETS (dist, speed,
length) configs, T=64 first, then 32, then 128, each through
``eval.test_model.evaluate_model_with_retry`` at batch 128 with --bf16
(dims 32, kernel 7), writing test_perf_dist_{d}_speed_{s}_length_{l}.npz
into ``results_folder`` (default build/torch_matrix). A config with no
shards under $PATHTRACKER_DATA_ROOT is rendered there first, as the
registry renders it ($PATHTRACKER_SYNTH_TRAIN / $PATHTRACKER_SYNTH_TEST
clips), the missing configs in parallel, one process each
(``render_missing``). It runs on the card; ``PATHTRACKER_TORCH_DEVICE=cpu`` asks for the
CPU. ``-b``, ``-d`` and ``-k`` set the batch and the model's width (a cut
sweep, or a checkpoint of another width).

Unlike the JAX driver it keeps no compile cache: the port compiles its
kernels once per source (ops/_native.py), whatever the config.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import sys
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def configs() -> list[dict]:
    """ALL_DATASETS, T=64 first, then 32, then 128 (the JAX driver's order)."""
    from pathtracker_torch.data.registry import ALL_DATASETS

    return sorted(ALL_DATASETS, key=lambda d: (d["length"] != 64, d["length"]))


def _render(key: tuple, scratch: str, sizes, dot_size: int | None = None) -> str:
    """One config rendered by the registry under ``scratch``, a data root of
    its own, with ``dot_size`` (None: the environment's); the config's
    folder there."""
    from pathtracker_torch.data import registry

    os.environ["PATHTRACKER_DATA_ROOT"] = scratch
    if dot_size is not None:
        os.environ["PATHTRACKER_DOT_SIZE"] = str(dot_size)
    n_train, n_test = sizes
    return registry.dataset_selector(*key, synth_train=n_train, synth_test=n_test)[0]


def render_missing(keys, workers: int = 8, sizes=(None, None), root: str | None = None,
                   dot_size: int | None = None):
    """Render each (dist, speed, length) config that has no train shards
    under ``root`` (default $PATHTRACKER_DATA_ROOT) in parallel processes,
    ``sizes`` (train, test) clips each (None: the registry's, from the
    environment), dots of ``dot_size`` pixels (None: the environment's);
    each lands in a scratch root and is renamed into place whole, so a
    reader sees a config complete or not at all. The configs rendered."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    from pathtracker_torch.data import registry

    root = root or registry.data_root()
    missing = [k for k in keys
               if not glob.glob(os.path.join(registry._config_dir(*k, root=root), "train-*"))]
    if not missing:
        return []
    scratch = f"{root}.render-{os.getpid()}-{id(missing)}"
    try:
        with ProcessPoolExecutor(min(workers, len(missing)),
                                 mp_context=get_context("spawn")) as pool:
            futures = {k: pool.submit(_render, k, os.path.join(scratch, "_".join(map(str, k))),
                                      sizes, dot_size)
                       for k in missing}
            done = {k: f.result() for k, f in futures.items()}
        for k, folder in done.items():
            target = registry._config_dir(*k, root=root)
            os.makedirs(os.path.dirname(target), exist_ok=True)
            try:
                os.rename(folder, target)
            except OSError:  # rendered meanwhile by another process: keep that one
                pass
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return missing


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ckpt")
    p.add_argument("results_folder", nargs="?",
                   default=os.path.join(ROOT, "build", "torch_matrix"))
    p.add_argument("model", nargs="?", default="InT")
    p.add_argument("-b", "--batch-size", type=int, default=128)
    p.add_argument("-d", "--dimensions", type=int, default=32)
    p.add_argument("-k", "--fb_kernel_size", type=int, default=7)
    a = p.parse_args(argv)

    from pathtracker_torch.eval.test_model import evaluate_model_with_retry

    args = SimpleNamespace(
        batch_size=a.batch_size, parallel=True, ckpt=a.ckpt, model=a.model,
        penalty="Testing", algo="Testing", dimensions=a.dimensions,
        fb_kernel_size=a.fb_kernel_size, seed=0, pretrained=False, bf16=True,
        device=os.environ.get("PATHTRACKER_TORCH_DEVICE") or None)
    render_missing([(d["dist"], d["speed"], d["length"]) for d in configs()])
    results = {}
    for d in configs():
        key = (d["dist"], d["speed"], d["length"])
        print(f"=== config dist={key[0]} speed={key[1]} length={key[2]} ===", flush=True)
        results[key] = evaluate_model_with_retry(
            a.results_folder, args, prep_gifs=0,
            dist=d["dist"], speed=d["speed"], length=d["length"])
        print(f"=== done {key}: acc={results[key][0]:.4f} "
              f"loss={results[key][1]:.4f} ===", flush=True)

    print("MATRIX COMPLETE")
    for key, (acc, loss) in results.items():
        print(f"{key}: {acc * 100:.2f}% / {loss:.4f} BCE", flush=True)
    return results


if __name__ == "__main__":
    main()
