"""Synthetic PathTracker clip renderer and dataset writer
(pathtracker_tpu/data/pathtracker.py).

T frames of 32x32 RGB: channel 0 carries the moving dots, channel 2 (blue)
the start marker on frame 0 and the candidate end marker on the last frame.
The label says whether the end marker sits on the tracked dot (1) or on a
distractor (0). Dots follow smooth constrained random walks: per-step
heading noise at constant speed, reflected at the borders. Given the same
``numpy`` generator state it draws the same numbers in the same order as
the JAX package's renderer, so both render the same clips, and
``make_synthetic_dataset`` writes the same GZIP TFRecord shards (the schema
the reference reads, utils/TFRDataset.py:7-12: label bytes, raw uint8
image [T,32,32,3], height, width).
"""

from __future__ import annotations

import os

import numpy as np

from pathtracker_torch.data.tfrecord import build_example, write_tfrecord_file


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
                            dot_size: int | None = None) -> tuple[np.ndarray, int]:
    """Render one clip: (uint8 [T,H,W,3], label in {0,1}). ``dot_size``
    None means ``$PATHTRACKER_DOT_SIZE``, 1 where it is unset."""
    if dot_size is None:
        raw = os.environ.get("PATHTRACKER_DOT_SIZE", "1")
        try:
            dot_size = int(raw)
        except ValueError:
            raise ValueError(
                f"$PATHTRACKER_DOT_SIZE must be an integer >= 1, got {raw!r}") from None
    if dot_size < 1:
        raise ValueError(f"dot_size must be >= 1 (got {dot_size}; check "
                         "$PATHTRACKER_DOT_SIZE)")
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
                 speed: float = 1.0, dot_size: int | None = None):
    """``batch`` clips from one seeded stream: (uint8 [B,T,32,32,3], int [B]);
    ``dot_size`` as in ``render_pathtracker_clip``."""
    rng = np.random.default_rng(seed)
    clips = [render_pathtracker_clip(rng, timesteps, n_distractors=n_distractors,
                                     speed=speed, dot_size=dot_size)
             for _ in range(batch)]
    return (np.stack([c for c, _ in clips]),
            np.array([label for _, label in clips], dtype=np.int64))


def make_synthetic_dataset(root: str, n_train: int = 64, n_test: int = 64,
                           timesteps: int = 64, size: int = 32,
                           n_distractors: int = 14, speed: float = 1.0,
                           shards: int = 2, seed: int = 0) -> str:
    """Render a train/test TFRecord dataset under ``root``; returns ``root``.

    One generator renders the train clips, then the test clips. Files are
    named ``{split}-{shard:05d}-of-{shards:05d}.tfrecord``, matching the
    reference's glob patterns 'train-*' / 'test-*' (reference
    mainclean.py:116-119); a split of 0 clips writes empty shards.
    """
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for split, count in (("train", n_train), ("test", n_test)):
        per_shard = -(-count // shards)
        idx = 0
        for shard in range(shards):
            payloads = []
            for _ in range(min(per_shard, count - idx)):
                clip, label = render_pathtracker_clip(
                    rng, timesteps=timesteps, size=size,
                    n_distractors=n_distractors, speed=speed)
                payloads.append(build_example({
                    "label": bytes([label]),
                    "image": clip.tobytes(),
                    "height": size,
                    "width": size,
                }))
                idx += 1
            path = os.path.join(root, f"{split}-{shard:05d}-of-{shards:05d}.tfrecord")
            write_tfrecord_file(path, payloads)
    return root


def _main():
    """CLI: render a PathTracker TFRecord dataset.

        python -m pathtracker_torch.data.pathtracker \\
            --root datasets/64_1_14 --length 64 --dist 14 \\
            --train 20000 --test 20000 --shards 10

    Dots are ``$PATHTRACKER_DOT_SIZE`` pixels wide (1 where it is unset)."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True)
    ap.add_argument("--train", type=int, default=20000)
    ap.add_argument("--test", type=int, default=20000)
    ap.add_argument("--length", type=int, default=64, help="frames per clip")
    ap.add_argument("--dist", type=int, default=14, help="distractor count")
    ap.add_argument("--speed", type=float, default=1.0)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--shards", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    out = make_synthetic_dataset(
        a.root, n_train=a.train, n_test=a.test, timesteps=a.length,
        size=a.size, n_distractors=a.dist, speed=a.speed, shards=a.shards,
        seed=a.seed)
    print(f"wrote {a.train}+{a.test} clips (T={a.length}, dist={a.dist}, "
          f"speed={a.speed:g}) under {out}")


if __name__ == "__main__":
    _main()
