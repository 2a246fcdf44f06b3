#!/usr/bin/env python3
"""The InT cell kernels and the train step of two checkouts of this
repository, in turns on one CUDA card.

    python3 scripts/torch_bwd_compare.py PARENT . . PARENT

Each argument is the root of a checkout (``.``: the one this script is in;
another one can be unpacked with ``git archive <commit> | tar -x -C DIR``).
For each, in the order given and each in a process of its own, the script
builds that checkout's kernels and runs two phases of this checkout's
``chip_smoke.py`` on that checkout's ``pathtracker_torch``: the forward and
the backward kernels at 131,072 x 32 against their plain versions (device
time per call, bound, each CUDA kernel of a backward call by name) and the
chainE train phase (10 counted steps, p50 step latency of the fused and the
eager path in turns, CUDA kernels per fused step). Two checkouts are
compared only within one run of this script: the same card, the same power
limit, taking turns.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_one(root: str) -> int:
    root = os.path.abspath(root)
    sys.path.insert(0, HERE)  # chip_smoke's phases
    sys.path.insert(0, root)  # the package under test, first
    import torch

    import chip_smoke
    import pathtracker_torch
    from pathtracker_torch.data.pathtracker import render_batch
    from pathtracker_torch.eval import serve
    from pathtracker_torch.ops import _native
    from pathtracker_torch.ops import int_fused as F

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    if not os.path.abspath(pathtracker_torch.__file__).startswith(root + os.sep):
        print(f"pathtracker_torch was not imported from {root}", file=sys.stderr)
        return 2
    print(f"== {root}: {chip_smoke.card_line()}", flush=True)
    _native.build(["int_cell", "int_cell_bwd"])
    for name in ("int_cell", "int_cell_bwd"):
        for line in chip_smoke.resource_lines(_native.build_log(name)):
            print(f"build: csrc/{name}.cu {line}", flush=True)
    rendered = [render_batch(seed, chip_smoke.BATCH, chip_smoke.TIMESTEPS,
                             n_distractors=chip_smoke.DISTRACTORS,
                             dot_size=chip_smoke.DOT_SIZE)
                for seed in range(chip_smoke.REQUESTS)]
    rows = chip_smoke.kernel_phase(F)
    rows += chip_smoke.backward_kernel_phase(F)
    chip_smoke.train_phase(serve, F, rows, rendered)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("roots", nargs="+", help="checkout roots, in running order")
    parser.add_argument("--one", action="store_true",
                        help="run the single root given, in this process")
    args = parser.parse_args()
    if args.one:
        return run_one(args.roots[0])
    for root in args.roots:
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root])
        if done.returncode != 0:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
