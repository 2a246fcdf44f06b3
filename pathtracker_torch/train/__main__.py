"""``python -m pathtracker_torch.train <flags>``: the training CLI
(pathtracker_tpu/train/__main__.py); the flags are utils/opts.py's.

It trains on the card; ``PATHTRACKER_TORCH_DEVICE=cpu`` asks for the CPU (the
port's counterpart of the JAX package's JAX_PLATFORMS=cpu). --parallel on a
host of k > 1 visible cards, with no COORDINATOR_ADDRESS, starts one process
a card (loop.launch); each process of a launch that sets
COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID itself trains on its own
card.

``PATHTRACKER_LAUNCHES=<file>``: at exit this process appends one JSON line
to the file, the launch count of every kernel wrapper (``ops.int_fused`` and
``ops.correlation``'s ``KERNELS``) by name, for a caller that runs the CLI
as a process and must show which kernels it ran (chip_smoke.py's chain
phase)."""

import json
import os

import torch

from pathtracker_torch.ops import correlation, int_fused
from pathtracker_torch.train.loop import launch, main
from pathtracker_torch.utils.opts import parser


def write_launches(path: str) -> None:
    counts = {k.__name__: k.launches for k in (*int_fused.KERNELS, *correlation.KERNELS)}
    with open(path, "a") as f:
        f.write(json.dumps(counts) + "\n")


if __name__ == "__main__":
    args = parser.parse_args()
    args.device = os.environ.get("PATHTRACKER_TORCH_DEVICE") or None
    cards = torch.cuda.device_count() if args.device in (None, "cuda") else 0
    try:
        if args.parallel and cards > 1 and not os.environ.get("COORDINATOR_ADDRESS"):
            launch(args, cards)
        else:
            main(args)
    finally:
        if os.environ.get("PATHTRACKER_LAUNCHES"):
            write_launches(os.environ["PATHTRACKER_LAUNCHES"])
