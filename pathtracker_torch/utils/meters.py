"""AverageMeter with full history (pathtracker_tpu/utils/meters.py;
reference utils/misc_functions.py:117-135).

The history list is load-bearing: it feeds the train.npz / val.npz
observability files that eval reads to pick checkpoints (reference
mainclean.py:228-234)."""

from __future__ import annotations


class AverageMeter:
    """Tracks current value, running average, and full history."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.history = []
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.history.append(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
