#!/usr/bin/env python3
"""The port's held-out eval of the in-tree chainE checkpoint, held against
the JAX package's record of it, on one CUDA card.

    python3 scripts/torch_heldout_eval.py

1. Renders the dist 14 / speed 1 / length 64 root through the port's
   ``dataset_selector`` with ``$PATHTRACKER_DOT_SIZE=2``, 20,000 train and
   2,500 test clips (the settings the record's root was rendered with,
   scripts/round5_queue.sh:38-40) under build/heldout/data. The test clips
   follow all 20,000 train clips in one RNG stream, so the whole root is
   rendered; a root already there is reused. Prints which codec wrote it.
2. Evaluates results_conv/64_1_14/chainE/saved_models/
   model_val_acc_0072_epoch_15_checkpoint.pth.tar at ``-b 128 --bf16``:
   once per loader seed 0-4 (``evaluate_batches`` over
   ``tfr_data_loader(..., seed=s)``, the loader ``evaluate_model`` builds,
   seeded), and once through ``evaluate_model`` itself, whose loader is
   unseeded as ``main`` runs it (its npz goes to build/heldout/results).
3. Prints each run's accuracy and BCE beside the JAX record
   (results/chainE_eval_0072_epoch_15/test_perf_dist_14_speed_1_length_64.npz:
   its loader was unseeded, so the record is one draw of the batching and
   of the 68 clips that drop), the verdict, and one JSON line. The record is
   reproduced when its accuracy and its BCE each lie within the range of
   the seeded runs'.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CHECKPOINT = os.path.join(ROOT, "results_conv", "64_1_14", "chainE", "saved_models",
                          "model_val_acc_0072_epoch_15_checkpoint.pth.tar")
RECORD = os.path.join(ROOT, "results", "chainE_eval_0072_epoch_15",
                      "test_perf_dist_14_speed_1_length_64.npz")
OUT = os.path.join(ROOT, "build", "heldout")
DIST, SPEED, LENGTH, BATCH = 14, 1, 64, 128
N_TRAIN, N_TEST = 20000, 2500
SEEDS = (0, 1, 2, 3, 4)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_heldout_eval: needs a CUDA card", file=sys.stderr)
        return 2
    os.environ.update(PATHTRACKER_DATA_ROOT=os.path.join(OUT, "data"),
                      PATHTRACKER_DOT_SIZE="2",
                      PATHTRACKER_SYNTH_TRAIN=str(N_TRAIN),
                      PATHTRACKER_SYNTH_TEST=str(N_TEST))
    from pathtracker_torch import engine
    from pathtracker_torch.data import native
    from pathtracker_torch.data.pipeline import tfr_data_loader
    from pathtracker_torch.eval import test_model

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    codec = "native" if native.available() else "python"
    t0 = time.perf_counter()
    root, timesteps, _, _ = engine.dataset_selector(DIST, SPEED, LENGTH)
    print(f"data: {root} ({N_TRAIN} + {N_TEST} clips, 2-pixel dots) ready in "
          f"{time.perf_counter() - t0:.1f} s; codec {codec}", flush=True)

    args = SimpleNamespace(model="InT", name="chainE", batch_size=BATCH, bf16=True,
                           dimensions=32, fb_kernel_size=7, ckpt=CHECKPOINT,
                           pretrained=False, algo="bptt")
    model = engine.load_ckpt(engine.model_selector(args, timesteps), CHECKPOINT).eval()
    batches = N_TEST // BATCH
    runs = []
    for seed in SEEDS:
        loader = tfr_data_loader(os.path.join(root, "test-*"), batch_size=BATCH,
                                 drop_remainder=True, timesteps=timesteps, seed=seed)
        t0 = time.perf_counter()
        accs, losses, _ = test_model.evaluate_batches(model, "InT", loader)
        if len(accs) != batches:
            raise RuntimeError(f"seed {seed}: {len(accs)} batches, expected {batches}")
        runs.append(dict(seed=seed, acc=float(np.mean(accs)), loss=float(np.mean(losses))))
        print(f"seed {seed}: accuracy {runs[-1]['acc']:.8f}, BCE {runs[-1]['loss']:.8f} "
              f"({len(accs)} batches of {BATCH}, {time.perf_counter() - t0:.1f} s)",
              flush=True)
    t0 = time.perf_counter()
    acc, loss = test_model.evaluate_model(os.path.join(OUT, "results", "chainE"), args,
                                          prep_gifs=0, dist=DIST, speed=SPEED,
                                          length=LENGTH)
    runs.append(dict(seed=None, acc=acc, loss=loss))
    print(f"unseeded (evaluate_model): accuracy {acc:.8f}, BCE {loss:.8f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    record = np.load(RECORD)
    want = {"acc": float(record["arr_0"]), "loss": float(record["arr_1"])}
    seeded = [r for r in runs if r["seed"] is not None]
    within = {}
    for key, value in want.items():
        lo, hi = min(r[key] for r in seeded), max(r[key] for r in seeded)
        within[key] = lo <= value <= hi
        print(f"JAX record {key} {value:.8f}: seeded runs span [{lo:.8f}, {hi:.8f}], "
              f"{'inside' if within[key] else 'outside'}", flush=True)
    verdict = "reproduced" if all(within.values()) else "not reproduced"
    print(f"verdict: {verdict}", flush=True)
    print(json.dumps({"card": card, "codec": codec, "record": want, "runs": runs,
                      "within": within, "verdict": verdict}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
