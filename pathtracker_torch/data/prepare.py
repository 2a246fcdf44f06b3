"""Device-side batch preparation (pathtracker_tpu/data/prepare.py).

uint8 wire frames go to the device as they are; layout, normalization and
the optional channel transforms run there.
"""

from __future__ import annotations

import numpy as np
import torch

# Kinetics video mean/std used when --pretrained (reference utils/engine.py:245-246).
VIDEO_MEAN = (0.43216, 0.394666, 0.37645)
VIDEO_STD = (0.22803, 0.22145, 0.216989)


def prepare_batch(imgs: torch.Tensor, labels: torch.Tensor,
                  disentangle_channels: bool = False,
                  pretrained_norm: bool = False,
                  coord_channels: bool = False):
    """uint8 [B,T,H,W,3] + uint8 [B] -> (f32 [B,C,T,H,W], f32 [B]), on the
    device of ``imgs``.

    Semantics match reference utils/engine.py:220-255:
      * /255 to [0,1], layout BTHWC -> BCTHW;
      * disentangle: mask = round(sum over channels); ch1 <- mask==1,
        ch2 <- mask==2, ch0 <- mask==3;
      * pretrained: (x - mean) / std with the Kinetics constants;
      * coord channels: append 1-indexed (hh, ww) meshgrids as 2 extra
        channels (for the `_cc` ResNet variants).
    """
    x = imgs.to(torch.float32) / 255.0
    x = x.permute(0, 4, 1, 2, 3)  # BTHWC -> BCTHW
    target = labels.to(torch.float32)

    if disentangle_channels:
        mask = torch.round(x.sum(dim=1))
        x = torch.stack([mask == 3, mask == 1, mask == 2], dim=1).to(x.dtype)

    if pretrained_norm:
        mean = torch.tensor(VIDEO_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(VIDEO_STD, dtype=x.dtype, device=x.device)
        x = (x - mean[None, :, None, None, None]) / std[None, :, None, None, None]

    if coord_channels:
        b, _, t, h, w = x.shape
        hh = torch.arange(1, h + 1, dtype=x.dtype, device=x.device)[:, None].expand(h, w)
        ww = torch.arange(1, w + 1, dtype=x.dtype, device=x.device)[None, :].expand(h, w)
        grids = torch.stack([hh, ww])[None, :, None].expand(b, 2, t, h, w)
        x = torch.cat([x, grids], dim=1)

    return x, target


def decode_labels(labels) -> np.ndarray:
    """Byte-string/byte labels -> float array (the reference's ord() decode)."""
    arr = np.asarray(labels)
    if arr.dtype.kind in "SU":  # byte/str labels from a tf.data source
        arr = np.vectorize(lambda s: ord(s) if isinstance(s, str) else s[0])(arr)
    return arr.astype(np.float32)
