"""``python -m pathtracker_torch.train <flags>``: the training CLI
(pathtracker_tpu/train/__main__.py); the flags are utils/opts.py's.

It trains on the card; ``PATHTRACKER_TORCH_DEVICE=cpu`` asks for the CPU (the
port's counterpart of the JAX package's JAX_PLATFORMS=cpu). --parallel on a
host of k > 1 visible cards, with no COORDINATOR_ADDRESS, starts one process
a card (loop.launch); each process of a launch that sets
COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID itself trains on its own
card."""

import os

import torch

from pathtracker_torch.train.loop import launch, main
from pathtracker_torch.utils.opts import parser

if __name__ == "__main__":
    args = parser.parse_args()
    args.device = os.environ.get("PATHTRACKER_TORCH_DEVICE") or None
    cards = torch.cuda.device_count() if args.device in (None, "cuda") else 0
    if args.parallel and cards > 1 and not os.environ.get("COORDINATOR_ADDRESS"):
        launch(args, cards)
    else:
        main(args)
