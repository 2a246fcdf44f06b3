"""Video classification presets (pathtracker_tpu/data/presets.py; reference
utils/presets.py).

Resize / flip / normalize pipelines with the Kinetics mean/std the reference
carried (imported but unused by its entry scripts; provided for real here).
Output is `[C, T, H, W] float32`, normalized — ready to batch into the
models' BCTHW contract.
"""

from __future__ import annotations

import numpy as np

from pathtracker_torch.data.transforms import (
    Augmentation,
    Compose,
    ConvertBCHWtoCBHW,
    ConvertBHWCtoBCHW,
    GroupScale,
    ToFloatTensorFormat,
)

KINETICS_MEAN = (0.43216, 0.394666, 0.37645)
KINETICS_STD = (0.22803, 0.22145, 0.216989)


class _Normalize:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32).reshape(1, -1, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(1, -1, 1, 1)

    def __call__(self, clip):  # [T, C, H, W]
        return (np.asarray(clip) - self.mean) / self.std


class VideoClassificationPresetTrain:
    def __init__(self, resize_size: int = 32, flip_index: int = 0,
                 mean=KINETICS_MEAN, std=KINETICS_STD):
        self.pipeline = Compose([
            GroupScale(resize_size),
            Augmentation(flip_index),
            ToFloatTensorFormat(),
            ConvertBHWCtoBCHW(),
            _Normalize(mean, std),
            ConvertBCHWtoCBHW(),
        ])

    def __call__(self, clip):
        return self.pipeline(clip)


class VideoClassificationPresetEval:
    def __init__(self, resize_size: int = 32, mean=KINETICS_MEAN,
                 std=KINETICS_STD):
        self.pipeline = Compose([
            GroupScale(resize_size),
            ToFloatTensorFormat(),
            ConvertBHWCtoBCHW(),
            _Normalize(mean, std),
            ConvertBCHWtoCBHW(),
        ])

    def __call__(self, clip):
        return self.pipeline(clip)
