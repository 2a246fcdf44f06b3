"""Synthetic PathTracker clip renderer (pathtracker_tpu/data/pathtracker.py:29-107).

T frames of 32x32 RGB: channel 0 carries the moving dots, channel 2 (blue)
the start marker on frame 0 and the candidate end marker on the last frame.
The label says whether the end marker sits on the tracked dot (1) or on a
distractor (0). Dots follow smooth constrained random walks: per-step
heading noise at constant speed, reflected at the borders. Given the same
``numpy`` generator state it draws the same numbers in the same order as
the JAX package's renderer, so both render the same clips.
"""

from __future__ import annotations

import numpy as np


def _walk(rng: np.random.Generator, n_dots: int, timesteps: int, speed: float,
          size: int) -> np.ndarray:
    """Smooth random walks, shape [n_dots, T, 2] in [0, size)."""
    pos = rng.uniform(2, size - 2, size=(n_dots, 2))
    heading = rng.uniform(0, 2 * np.pi, size=n_dots)
    step = 0.8 * speed
    out = np.empty((n_dots, timesteps, 2), dtype=np.float32)
    for t in range(timesteps):
        out[:, t] = pos
        heading += rng.normal(0.0, 0.45, size=n_dots)
        delta = np.stack([np.cos(heading), np.sin(heading)], -1) * step
        pos = pos + delta
        for axis in range(2):  # reflect at borders
            low = pos[:, axis] < 1
            high = pos[:, axis] > size - 2
            pos[low, axis] = 2 - pos[low, axis]
            pos[high, axis] = 2 * (size - 2) - pos[high, axis]
        pos = np.clip(pos, 1, size - 2)
    return out


def _splat(canvas: np.ndarray, yx: np.ndarray, value: int, size: int) -> None:
    """Draw size x size dots at float coords (nearest pixel) into [H,W] uint8."""
    ij = np.round(yx).astype(np.int64)
    for dy in range(-(size // 2), size - size // 2):
        for dx in range(-(size // 2), size - size // 2):
            p = np.clip(ij + np.array([dy, dx]), 0, canvas.shape[0] - 1)
            canvas[p[..., 0], p[..., 1]] = value


def render_pathtracker_clip(rng: np.random.Generator, timesteps: int = 64,
                            size: int = 32, n_distractors: int = 14,
                            speed: float = 1.0, positive: bool | None = None,
                            dot_size: int = 1) -> tuple[np.ndarray, int]:
    """Render one clip: (uint8 [T,H,W,3], label in {0,1})."""
    if dot_size < 1:
        raise ValueError(f"dot_size must be >= 1, got {dot_size}")
    if positive is None:
        positive = bool(rng.integers(0, 2))
    tracks = _walk(rng, n_distractors + 1, timesteps, speed, size)  # [n, T, 2]
    target = tracks[0]

    clip = np.zeros((timesteps, size, size, 3), dtype=np.uint8)
    for t in range(timesteps):
        _splat(clip[t, :, :, 0], tracks[:, t], 255, dot_size)  # all dots, red
    _splat(clip[0, :, :, 2], target[0], 255, dot_size)  # start marker
    if positive or n_distractors == 0:
        end, label = target[-1], 1
    else:
        end, label = tracks[1 + rng.integers(0, n_distractors), -1], 0
    _splat(clip[-1, :, :, 2], end, 255, dot_size)  # candidate end marker
    return clip, label


def render_batch(seed: int, batch: int, timesteps: int = 64, n_distractors: int = 14,
                 speed: float = 1.0, dot_size: int = 1):
    """``batch`` clips from one seeded stream: (uint8 [B,T,32,32,3], int [B])."""
    rng = np.random.default_rng(seed)
    clips = [render_pathtracker_clip(rng, timesteps, n_distractors=n_distractors,
                                     speed=speed, dot_size=dot_size)
             for _ in range(batch)]
    return (np.stack([c for c, _ in clips]),
            np.array([label for _, label in clips], dtype=np.int64))
