"""Group video transforms (pathtracker_tpu/data/transforms.py; reference
utils/transforms.py).

The reference shipped torchvision-backed group transforms that its scripts
imported but left disabled (`use_augmentations=False`, reference
mainclean.py:40). They are provided here as numpy clip transforms so the
capability exists for real: each callable maps a clip `[T, H, W, C] uint8`
(or a list of frames) to the transformed clip. Deterministic flips are
selected by index exactly like the reference's `Augmentation` (reference
utils/transforms.py: 4-way flip by flip_index), which its legacy dataset
drove from the sample index.
"""

from __future__ import annotations

import numpy as np


class GroupScale:
    """Resize every frame to `size` x `size` (reference GroupScale).

    Nearest-neighbor resampling: the PathTracker dot/distractor stimuli are
    binary-ish small sprites where bilinear smearing changes the task.
    """

    def __init__(self, size: int):
        self.size = int(size)

    def __call__(self, clip):
        clip = np.asarray(clip)
        t, h, w, c = clip.shape
        if (h, w) == (self.size, self.size):
            return clip
        ys = (np.arange(self.size) * (h / self.size)).astype(np.int64)
        xs = (np.arange(self.size) * (w / self.size)).astype(np.int64)
        return clip[:, ys][:, :, xs]


class Augmentation:
    """4-way deterministic flip by index (reference Augmentation):
    0 = identity, 1 = horizontal, 2 = vertical, 3 = both."""

    def __init__(self, flip_index: int = 0):
        self.flip_index = int(flip_index) % 4

    def __call__(self, clip):
        clip = np.asarray(clip)
        if self.flip_index in (1, 3):
            clip = clip[:, :, ::-1]
        if self.flip_index in (2, 3):
            clip = clip[:, ::-1]
        return np.ascontiguousarray(clip)


class Stack:
    """Stack a list of [H, W, C] frames into [T, H, W, C] (reference Stack)."""

    def __call__(self, frames):
        return np.stack([np.asarray(f) for f in frames], axis=0)


class ToFloatTensorFormat:
    """uint8 [0,255] -> float32 [0,1] (reference ToTorchFormatTensor's /255)."""

    def __call__(self, clip):
        return np.asarray(clip).astype(np.float32) / 255.0


class ConvertBHWCtoBCHW:
    """[T, H, W, C] -> [T, C, H, W] (reference ConvertBHWCtoBCHW)."""

    def __call__(self, clip):
        return np.transpose(np.asarray(clip), (0, 3, 1, 2))


class ConvertBCHWtoCBHW:
    """[T, C, H, W] -> [C, T, H, W] (reference ConvertBCHWtoCBHW) — the
    models' BCTHW layout for one sample."""

    def __call__(self, clip):
        return np.transpose(np.asarray(clip), (1, 0, 2, 3))


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, clip):
        for t in self.transforms:
            clip = t(clip)
        return clip
