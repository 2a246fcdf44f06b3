"""Legacy file-list video dataset (pathtracker_tpu/data/legacy_dataset.py;
reference utils/dataset.py).

The reference carried a PIL-backed torch Dataset over "video record" file
lists (`VideoRecord`, `DataSetPol`, `DataSetSeg`) predating the TFRecord
pipeline; entry scripts never used it. Equivalent capability here: an
iterable dataset over a list file of `path num_frames label` lines, loading
frames from per-video directories of numbered images, with the same
flip-augmentation-by-index trick (sample index modulo 4 picks the flip).

Frames load via PIL when available (as in the reference) and fall back to
npy frame dumps; the output contract matches the rest of this framework:
(clip uint8 [T, H, W, C], label int).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from pathtracker_torch.data.transforms import Augmentation


class VideoRecord:
    """One line of a list file: `path num_frames label` (reference VideoRecord)."""

    def __init__(self, row: Sequence[str]):
        self._data = list(row)

    @property
    def path(self) -> str:
        return self._data[0]

    @property
    def num_frames(self) -> int:
        return int(self._data[1])

    @property
    def label(self) -> int:
        return int(self._data[2])


def _load_frame(directory: str, idx: int, image_tmpl: str):
    path = os.path.join(directory, image_tmpl.format(idx))
    if os.path.exists(path + ".npy"):
        return np.load(path + ".npy")
    try:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    except ImportError as e:  # PIL absent: npy fallback only
        raise FileNotFoundError(f"{path} (PIL unavailable: {e})")


class DataSetPol:
    """Index-addressable clip dataset over a list file (reference DataSetPol).

    Augmentation: sample index modulo 4 selects the deterministic 4-way flip,
    exactly the reference's flip-index trick."""

    def __init__(self, root_path: str, list_file: str,
                 image_tmpl: str = "{:05d}.png", transform=None,
                 use_augmentations: bool = False):
        self.root_path = root_path
        self.image_tmpl = image_tmpl
        self.transform = transform
        self.use_augmentations = use_augmentations
        with open(list_file) as f:
            self.video_list = [VideoRecord(line.split())
                               for line in f if line.strip()]

    def __len__(self) -> int:
        return len(self.video_list)

    def __getitem__(self, index: int):
        record = self.video_list[index]
        directory = os.path.join(self.root_path, record.path)
        clip = np.stack([
            _load_frame(directory, i + 1, self.image_tmpl)
            for i in range(record.num_frames)
        ])
        if self.use_augmentations:
            clip = Augmentation(index % 4)(clip)
        if self.transform is not None:
            clip = self.transform(clip)
        return clip, record.label

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class DataSetSeg(DataSetPol):
    """Segmentation-flavored variant (reference DataSetSeg): the target is a
    mask clip loaded from a sibling `<path>_mask` directory, flipped with the
    same augmentation index as the input so input/target stay aligned."""

    def __getitem__(self, index: int):
        record = self.video_list[index]
        directory = os.path.join(self.root_path, record.path)
        clip = np.stack([
            _load_frame(directory, i + 1, self.image_tmpl)
            for i in range(record.num_frames)
        ])
        mask = np.stack([
            _load_frame(directory + "_mask", i + 1, self.image_tmpl)
            for i in range(record.num_frames)
        ])
        if self.use_augmentations:
            aug = Augmentation(index % 4)
            clip, mask = aug(clip), aug(mask)
        if self.transform is not None:
            clip = self.transform(clip)
        return clip, mask
