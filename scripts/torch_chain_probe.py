#!/usr/bin/env python3
"""One stage of the canonical chain (scripts/torch_reproduce_canonical.py)
under variants, side by side on one CUDA card, held against the JAX
package's run of the same stage: which of the port's cell, precision and
starting weights decide where the stage goes.

    python3 scripts/torch_chain_probe.py [--stage A|B|C] [--epochs N]
        [--ckpt START] [--variants fused,eager,f32,fused+ckpt,fused+s1,...]
        [--results-root build/chain] [--transfer] [--heldout] [--out build/chain_probe]
        [--score-only]

Each variant is a process of this script training the stage's command
(``torch_reproduce_canonical.stage_flags``: batch 128, --device-data
--fused-steps 12, 20,000 + 2,500 clips, C with its EMA) through
``train.loop.main``, all at once:

  fused      --bf16: the K1-K3 kernels (the chain's default cell)
  eager      --bf16 on the eager mixed cell (``fused=False``), the cell
             the JAX package trained its chain on
  f32        without --bf16: the f32 eager cell

(the cells of ``torch_reproduce_canonical.cell``, which the chain's CELL
knob uses too)
  <v>+ckpt   starting from --ckpt's weights (e.g. the JAX package's
             checkpoint of the stage before, or its seeded init for A)
  <v>+sN     the model's init drawn from seed N (the data order stays
             seed 0's)

Without +ckpt, B and C start from the previous stage's best checkpoint in
--results-root, as the chain does, and A from the seeded init.

It prints, for each variant beside the JAX package's run of the stage
(results_conv/.../chain{A,B,C}): the val meter (the first epoch above 75%
balanced accuracy, the best and its epoch, every epoch's value), every
epoch's mean train loss, and the mean absolute gap between the variant's
per-step train losses and JAX's over the first epoch (the batches are the
same: data/prng.py draws JAX's permutation, and the renderer is
byte-equal, so from the same weights the losses start equal). Then each
variant's seconds, with --transfer (stage B) each variant's best-val
checkpoints scored on stage C's held-out shard (loader seeds 0-2), as
``torch_reproduce_canonical.py --transfer`` scores the chain's, with
--heldout every best-val checkpoint of each variant (``model_val_acc_*``,
the best-val one marked) scored on the stage's own held-out shard under
the report's ten loader seeds, beside the JAX package's held-out record of
its own checkpoint at the same epoch where there is one
(``torch_reproduce_canonical.jax_records``), and one JSON line. The runs
go under <out>/<stage>/ (default build/chain_probe; the data root is
$PATHTRACKER_DATA_ROOT, else build/chain/data). --score-only, a recovery
tool for a run that was cut short (its folder copied back under <out>),
trains nothing and compares and scores the runs already there; their
exit code and seconds read null. --heldout takes a run's best-val
checkpoint from val.npz's best epoch, not from the files' times.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch_reproduce_canonical as canon  # noqa: E402

OUT = os.path.join(ROOT, "build", "chain_probe")
PREVIOUS = {"B": "A", "C": "B"}


def _flags(stage: str, variant: str, epochs: int, ckpt: str | None,
           results_root: str, out: str = OUT) -> tuple[list[str], dict]:
    """The stage's flags for ``variant`` and the model keywords it sets."""
    base, *mods = variant.split("+")
    k = dict(canon.knobs(), **{canon.STAGES[stage][3][0]: str(epochs)})
    start = None
    if stage in PREVIOUS and "ckpt" not in mods:
        start = canon.best_checkpoint(canon.run_folder(results_root, PREVIOUS[stage], k))
    flags = canon.stage_flags(stage, k, os.path.join(out, stage, variant), start)
    flags[flags.index("--name") + 1] = f"probe_{variant}"
    flags, kwargs = canon.cell(base, flags)
    for mod in mods:
        if mod == "ckpt" and ckpt:
            flags += ["--ckpt", ckpt]
        elif mod.startswith("s") and mod[1:].isdigit():
            kwargs["seed"] = int(mod[1:])
        else:
            raise ValueError(f"unknown variant {variant!r} (+ckpt needs --ckpt)")
    return flags, kwargs


def run(stage: str, variant: str, epochs: int, ckpt: str | None, results_root: str,
        out: str = OUT) -> int:
    """One variant in this process."""
    from pathtracker_torch.train import loop

    flags, kwargs = _flags(stage, variant, epochs, ckpt, results_root, out)
    args = loop.parser.parse_args(flags)
    args.device = os.environ.get("PATHTRACKER_TORCH_DEVICE") or None
    loop.main(args, model_kwargs=kwargs)
    return 0


def compare(folder: str, jax_folder: str) -> dict | None:
    """A run's val meter and train losses against the JAX package's run."""
    c = canon.curve(os.path.join(folder, "val.npz"))
    if c is None:
        return None
    val = np.load(os.path.join(folder, "val.npz"))["balacc"]
    train = np.load(os.path.join(folder, "train.npz"))["loss"]
    jax_train = np.load(os.path.join(jax_folder, "train.npz"))["loss"]
    per_epoch = len(jax_train) // len(np.load(os.path.join(jax_folder, "val.npz"))["loss"])
    first = min(per_epoch, len(train))
    return {"curve": c, "val": [round(float(x), 2) for x in val],
            "train_loss": [round(float(x), 4)
                           for x in train[:len(train) // per_epoch * per_epoch]
                           .reshape(-1, per_epoch).mean(axis=1)],
            "first_losses": [round(float(x), 4) for x in train[:8]],
            "gap_to_jax_first_epoch": float(np.abs(train[:first] - jax_train[:first]).mean())}


def heldout(stage: str, folder: str, k: dict, results_root: str) -> dict:
    """Every best-val checkpoint of the run ``folder`` on the stage's own
    held-out shard under all of the report's loader seeds (its seeded
    passes), each with its epoch and the JAX package's record at that
    epoch; which one is the best-val checkpoint, the one saved at val.npz's
    best epoch (the next stage loads it: checkpoints are saved only when
    the val meter improves)."""
    length, dist, _, _ = canon.STAGES[stage]
    records = canon.jax_records(stage)
    saved = os.path.join(folder, "saved_models")
    names = sorted((n for n in (os.listdir(saved) if os.path.isdir(saved) else ())
                    if n.startswith("model_val_acc_")), key=canon._epoch)
    best_epoch = (int(np.argmax(np.load(os.path.join(folder, "val.npz"))["balacc"]))
                  if names else None)
    out = {"best": next((n for n in names if canon._epoch(n) == best_epoch), None),
           "checkpoints": {}}
    device = os.environ.get("PATHTRACKER_TORCH_DEVICE") or None
    for name in names:
        args = canon._eval_args(k, results_root, stage, device, os.path.join(saved, name))
        got = canon.seeded_passes(args, dist, length, canon.SEEDS)
        epoch = canon._epoch(name)
        got.update(epoch=epoch, record=records.get(epoch))
        out["checkpoints"][name] = got
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stage", default="A", choices=sorted(canon.STAGES))
    p.add_argument("--epochs", type=int, default=None,
                   help="epochs a variant (default: the stage's knob)")
    p.add_argument("--ckpt", default=None, help="starting weights of the *+ckpt variants")
    p.add_argument("--variants", default="fused,eager,f32")
    p.add_argument("--results-root", default=os.path.join(ROOT, "build", "chain"),
                   help="the chain whose previous stage B and C start from")
    p.add_argument("--transfer", action="store_true",
                   help="stage B: then score each variant's checkpoints on stage C's shard")
    p.add_argument("--heldout", action="store_true",
                   help="then score each variant's best-val checkpoints on the stage's own "
                        "held-out shard under the report's ten loader seeds")
    p.add_argument("--out", default=OUT, help="where the variants' runs go")
    p.add_argument("--score-only", action="store_true",
                   help="recovery: train nothing, compare and score the variants' runs "
                        "already in --out")
    p.add_argument("--run", default=None, help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    os.environ.setdefault("PATHTRACKER_DATA_ROOT", os.path.join(ROOT, "build", "chain", "data"))
    os.environ.setdefault("PATHTRACKER_DOT_SIZE", "2")
    k = canon.knobs()
    epochs = a.epochs or int(k[canon.STAGES[a.stage][3][0]])
    results_root, out_root = os.path.abspath(a.results_root), os.path.abspath(a.out)
    if a.run:
        return run(a.stage, a.run, epochs, a.ckpt, results_root, out_root)

    from pathtracker_torch import engine

    length, dist, _, _ = canon.STAGES[a.stage]
    t0 = time.perf_counter()
    engine.dataset_selector(dist, canon.SPEED, length, synth_train=int(k["SYNTH_TRAIN"]),
                            synth_test=int(k["SYNTH_TEST"]))
    print(f"probe: stage {a.stage}'s root ready in {time.perf_counter() - t0:.1f} s",
          flush=True)
    variants = [v.strip() for v in a.variants.split(",") if v.strip()]
    for v in variants:  # refuse a bad name before starting any
        print(f"probe: [{v}] "
              f"{' '.join(_flags(a.stage, v, epochs, a.ckpt, results_root, out_root)[0])}",
              flush=True)
    out_dir = os.path.join(out_root, a.stage)
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for v in variants if not a.score_only else ():
        log = open(os.path.join(out_dir, f"{v}.log"), "w")
        cmd = [sys.executable, "-u", os.path.abspath(__file__), "--run", v, "--stage",
               a.stage, "--epochs", str(epochs), "--results-root", results_root,
               "--out", out_root]
        procs[v] = (subprocess.Popen(cmd + (["--ckpt", a.ckpt] if a.ckpt else []),
                                     stdout=log, stderr=subprocess.STDOUT, cwd=ROOT),
                    log, time.perf_counter())
    jax_folder = os.path.dirname(canon.JAX_CURVES[a.stage])
    jax = np.load(os.path.join(jax_folder, "train.npz"))["loss"]
    per_epoch = len(jax) // len(np.load(canon.JAX_CURVES[a.stage])["loss"])
    out = {"stage": a.stage, "epochs": epochs, "jax": {
        "curve": canon.curve(canon.JAX_CURVES[a.stage]),
        "val": [round(float(x), 2) for x in np.load(canon.JAX_CURVES[a.stage])["balacc"]],
        "train_loss": [round(float(x), 4) for x in jax.reshape(-1, per_epoch).mean(axis=1)],
        "first_losses": [round(float(x), 4) for x in jax[:8]]}, "variants": {}}
    print(f"probe: JAX chain{a.stage}: val meter {out['jax']['val']}; train loss an epoch "
          f"{out['jax']['train_loss']}; first steps {out['jax']['first_losses']}", flush=True)
    for v in variants:
        rc, seconds = None, None  # --score-only: no process ran
        if v in procs:
            proc, log, start = procs[v]
            rc = proc.wait()
            log.close()
            seconds = time.perf_counter() - start
        folder = os.path.join(out_dir, v, "results_conv", f"{length}_{canon.SPEED}_{dist}",
                              f"probe_{v}")
        row = compare(folder, jax_folder)
        out["variants"][v] = {"rc": rc, "seconds": seconds, **(row or {})}
        print((f"probe: [{v}] exit {rc} after {seconds:.1f} s; " if v in procs else
               f"probe: [{v}] not run (--score-only); ") + (
            "no epoch" if row is None else
            f"val meter first above {canon.ABOVE:g}% at epoch {row['curve']['first_above_75']}, "
            f"best {row['curve']['best']:.2f}% at epoch {row['curve']['best_epoch']}: "
            f"{row['val']}; train loss an epoch {row['train_loss']}; first steps "
            f"{row['first_losses']}; mean |loss - JAX's| over the first epoch "
            f"{row['gap_to_jax_first_epoch']:.4f}"), flush=True)
    if a.transfer and a.stage == "B":
        c_length, c_dist, _, _ = canon.STAGES["C"]
        for v, row in out["variants"].items():
            saved = os.path.join(out_dir, v, "results_conv", f"{length}_{canon.SPEED}_{dist}",
                                 f"probe_{v}", "saved_models")
            for name in sorted(os.listdir(saved)) if os.path.isdir(saved) else ():
                if not name.startswith("model_val_acc_"):
                    continue
                args = canon._eval_args(k, results_root, "C", None, os.path.join(saved, name))
                args.device = os.environ.get("PATHTRACKER_TORCH_DEVICE") or None
                got = canon.seeded_passes(args, c_dist, c_length, canon.SEEDS[:3])
                row.setdefault("transfer", {})[name] = got
                print(f"probe: transfer [{v}] {name} on C's shard: {100 * got['acc']:.2f}% / "
                      f"{got['loss']:.4f} BCE (mean of 3 seeded passes)", flush=True)
    for v, row in out["variants"].items() if a.heldout else ():
        folder = os.path.join(out_dir, v, "results_conv", f"{length}_{canon.SPEED}_{dist}",
                              f"probe_{v}")
        row["heldout"] = got = heldout(a.stage, folder, k, results_root)
        for name, s in got["checkpoints"].items():
            r = s["record"]
            print(f"probe: held-out [{v}] epoch {s['epoch']}"
                  f"{' (best-val)' if name == got['best'] else ''}: {100 * s['acc']:.2f}% / "
                  f"{s['loss']:.4f} BCE (mean of {len(s['seeded'])} seeded passes); JAX "
                  f"chain{a.stage} at epoch {s['epoch']}: " + (
                      "no record" if r is None else
                      f"{100 * r['acc']:.2f}% / {r['loss']:.4f} BCE"), flush=True)
    print(json.dumps(out), flush=True)
    return 0 if all(r["rc"] in (0, None) for r in out["variants"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
