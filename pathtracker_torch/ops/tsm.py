"""Temporal Shift Module (pathtracker_tpu/ops/tsm.py; reference
models/tsm_util.py:4-22).

Splits channels into 1/8 shifted forward, 1/8 shifted backward, 3/4
unshifted, along the frame axis. 'zero' pads the rolled-off frame with
zeros; 'circulant' wraps."""

from __future__ import annotations

import torch


def tsm(x, version: str = "zero"):
    """x: [B, T, H, W, C] -> same shape, channels temporally shifted."""
    split = x.shape[-1] // 8
    pre, post, peri = x[..., :split], x[..., split:2 * split], x[..., 2 * split:]
    if version == "zero":
        pre = torch.cat([pre[:, 1:], torch.zeros_like(pre[:, :1])], dim=1)
        post = torch.cat([torch.zeros_like(post[:, :1]), post[:, :-1]], dim=1)
    elif version == "circulant":
        pre = torch.roll(pre, shifts=-1, dims=1)
        post = torch.roll(post, shifts=1, dims=1)
    else:
        raise ValueError(version)
    return torch.cat([pre, post, peri], dim=-1)
