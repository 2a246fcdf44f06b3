#!/usr/bin/env python3
"""The hand-written kernels and the InT train step of two checkouts of this
repository, in turns on one CUDA card.

    python3 scripts/torch_bwd_compare.py PARENT . . PARENT [--phases int,correlation]

Each argument is the root of a checkout (``.``: the one this script is in;
another one can be unpacked with ``git archive <commit> | tar -x -C DIR``).
For each, in the order given and each in a process of its own, the script
builds that checkout's kernels and runs phases of this checkout's
``chip_smoke.py`` on that checkout's ``pathtracker_torch``:
  int          the InT forward and backward kernels at 131,072 x 32 against
               their plain versions (device time per call, bound, each CUDA
               kernel of a backward call by name) and the chainE train phase
               (10 counted steps, p50 step latency of the fused and the eager
               path in turns, CUDA kernels per fused step);
  correlation  the correlation kernels against their plain versions at the
               rntsm serving shape (N=504 images of 32x32x64, patch 15) and
               the train step's (N=252), and the device time per call of
               correlation_fwd, correlation_bwd_f1 and correlation_bwd_f2 at
               both, with their bound and registers;
  resident     chip_smoke.py's phase 13 (e) step times (train_InT.sh's
               batch of 180 at T=64, --bf16, from chainE): the streaming
               step's warm median, then resident windows of K = 1, 4 and 8
               steps, each one CUDA graph; the clips are one seeded batch of
               180, rendered here and repeated to an epoch of 15 steps;
  plateau      chip_smoke.py's phase-6 plateau check (two stage-A steps from
               the JAX chainA's epoch 38 through the fused and the eager
               cell) at 128, 32 and 2 clips a step, printed, not held;
Two checkouts are compared only within one run of this script: the same
card, the same power limit, taking turns.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_one(root: str, phases: list[str]) -> int:
    root = os.path.abspath(root)
    sys.path.insert(0, HERE)  # chip_smoke's phases
    sys.path.insert(0, root)  # the package under test, first
    import numpy as np
    import torch

    import chip_smoke
    import pathtracker_torch
    from pathtracker_torch.data.pathtracker import render_batch
    from pathtracker_torch.eval import serve
    from pathtracker_torch.ops import _native
    from pathtracker_torch.ops import correlation as Co
    from pathtracker_torch.ops import int_fused as F

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    if not os.path.abspath(pathtracker_torch.__file__).startswith(root + os.sep):
        print(f"pathtracker_torch was not imported from {root}", file=sys.stderr)
        return 2
    print(f"== {root}: {chip_smoke.card_line()}", flush=True)
    libs = (["int_cell", "int_cell_bwd"] if set(phases) - {"correlation"} else []) + (
        ["correlation"] if "correlation" in phases else [])
    _native.build(libs)
    resources = chip_smoke.print_resources(_native, libs)
    if "int" in phases:
        rendered = [render_batch(seed, chip_smoke.BATCH, chip_smoke.TIMESTEPS,
                                 n_distractors=chip_smoke.DISTRACTORS,
                                 dot_size=chip_smoke.DOT_SIZE)
                    for seed in range(chip_smoke.REQUESTS)]
        rows = chip_smoke.kernel_phase(F)
        rows += chip_smoke.backward_kernel_phase(F)
        chip_smoke.train_phase(serve, F, rows, rendered)
        del rendered
        torch.cuda.empty_cache()
    if "correlation" in phases:
        for n in (chip_smoke.CORR_N, chip_smoke.CORR_TRAIN_N):
            f1, f2, g = chip_smoke.correlation_inputs(
                Co, n, chip_smoke.SIDE, chip_smoke.SIDE, chip_smoke.CORR_C,
                chip_smoke.PATCH, 3)
            errs = chip_smoke.correlation_errors(Co, f1, f2, g, chip_smoke.PATCH, 1)
            for name, err in zip(chip_smoke.CORR_INSTANCES, errs):
                t = chip_smoke.correlation_timing(Co, name, f1, f2, g, plain=False)
                print(f"correlation: {name} N={n}: {t['ms']:.4f} ms, bound "
                      f"{t['bound_ms']:.4f} ms ({t['bound_ms'] / t['ms']:.1%}), max_abs_err "
                      f"{err:.3g}, wrapper {t['per_call_ms']:.4f} ms/call from Python | "
                      f"{resources.get(chip_smoke.CORR_INSTANCES[name], 'see the build lines')}",
                      flush=True)
            del f1, f2, g
            torch.cuda.empty_cache()
    if "resident" in phases:
        dev = torch.device("cuda")
        b = chip_smoke.REFERENCE_BATCH
        clips, labels = render_batch(0, b, chip_smoke.TIMESTEPS,
                                     n_distractors=chip_smoke.DISTRACTORS,
                                     dot_size=chip_smoke.DOT_SIZE)
        clips = torch.from_numpy(clips).to(dev).repeat(chip_smoke.RESIDENT_EPOCH, 1, 1, 1, 1)
        labels = torch.from_numpy(labels.astype(np.uint8)).to(dev).repeat(
            chip_smoke.RESIDENT_EPOCH)

        def epoch():
            return ((clips[i:i + b], labels[i:i + b]) for i in range(0, len(labels), b))

        chip_smoke.resident_times(serve, epoch, clips, labels, dev, float("nan"),
                                  chip_smoke.card_line())
    if "plateau" in phases:
        chip_smoke.fail = lambda msg: print(f"plateau: past the phase's bounds: {msg}",
                                            flush=True)
        for batch in (128, 32, 2):
            chip_smoke.PLATEAU_BATCH = batch
            chip_smoke.plateau_check(serve, F)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("roots", nargs="+", help="checkout roots, in running order")
    parser.add_argument("--phases", default="int,correlation",
                        help="comma-separated: int, correlation, resident, plateau "
                        "(default int,correlation)")
    parser.add_argument("--one", action="store_true",
                        help="run the single root given, in this process")
    args = parser.parse_args()
    phases = args.phases.split(",")
    if not set(phases) <= {"int", "correlation", "resident", "plateau"}:
        parser.error(f"unknown phases in {args.phases!r}")
    if args.one:
        return run_one(args.roots[0], phases)
    for root in args.roots:
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                               "--phases", args.phases, root])
        if done.returncode != 0:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
