"""Early stopping + best-checkpoint saving (pathtracker_tpu/utils/
earlystopping.py; reference utils/earlystopping.py).

Save on every val-accuracy improvement under
  saved_models/model_val_acc_{acc:04d}_epoch_{epoch:02d}_checkpoint.pth.tar
and raise the early_stop flag after ``patience`` non-improving epochs. The
checkpoints are the JAX package's msgpack dict {state_dict, epoch, acc,
extra}, in its parameter names and layouts (train/checkpoint.py)."""

from __future__ import annotations

import os

from pathtracker_torch.train.checkpoint import save_checkpoint


class EarlyStopping:
    def __init__(self, patience: int = 7, verbose: bool = False, delta: float = 0.0,
                 results_folder: str = "checkpoint", trace_func=print):
        self.patience = patience
        self.verbose = verbose
        self.counter = 0
        self.best_score = None
        self.early_stop = False
        self.delta = delta
        self.path = results_folder
        self.trace_func = trace_func
        os.makedirs(self.path, exist_ok=True)

    def __call__(self, acc: float, state_dict: dict, epoch: int,
                 extra: dict | None = None):
        if self.best_score is None or acc >= self.best_score + self.delta:
            if self.best_score is not None and self.verbose:
                self.trace_func(
                    f"Validation acc increased ({self.best_score:.6f} --> {acc:.6f}). Saving model ...")
            self.best_score = acc
            self.counter = 0
            self._save(acc, state_dict, epoch, extra)
        else:
            self.counter += 1
            self.trace_func(f"EarlyStopping counter: {self.counter} out of {self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True

    def _save(self, acc: float, state_dict: dict, epoch: int, extra: dict | None):
        folder = os.path.join(self.path, "saved_models")
        os.makedirs(folder, exist_ok=True)
        filename = "model_val_acc_{0:04d}_epoch_{1:02d}_checkpoint.pth.tar".format(
            int(acc), epoch)
        save_checkpoint(os.path.join(folder, filename), state_dict, epoch=epoch,
                        acc=acc, extra=extra)
