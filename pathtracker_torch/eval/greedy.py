"""Greedy nearest-neighbor tracker — the algorithmic baseline for PathTracker
(pathtracker_tpu/eval/greedy.py, numpy only: the answers are bit-equal).

Follow the dot (channel 0) closest to the previous tracked position, starting
from the frame-0 start marker (channel 2), and answer whether the final
position sits on the end marker (channel 2, last frame). This is the
"tracking without re-recognition is easy until identities swap" baseline:
its accuracy on a dataset config is the bar a recurrent model must beat to
demonstrate it resolves crossing ambiguities (BASELINE.md cites these bars
for every canonical config; tests/test_tfrecord.py pins the difficulty
ordering).

Also used as the PROXY for human per-clip responses in the viz flow when the
reference's MTurk asset (`mturk_responses/*_average_responses.npy`,
reference viz_model_att.py:148-152) is absent — the asset ships nowhere, so
without a proxy the model-vs-human printout would compare against noise.
The greedy tracker is the closest available stand-in for the human strategy
("follow the dot"), and its response confidence decays with the distance
between the tracked endpoint and the end marker.

CLI (measures the bar on actual shards, reproducing the BASELINE.md numbers):

    python -m pathtracker_torch.eval.greedy \
        --glob 'datasets/pathtracker_64_32_32/14_dist_speed_1/tfrecords/test-*' \
        --n 1000
"""

from __future__ import annotations

import numpy as np


def _marker_center(frame_channel: np.ndarray) -> np.ndarray:
    """Center of mass of the lit marker pixels in one [H,W] channel."""
    pix = np.argwhere(frame_channel > 0)
    if pix.size == 0:  # blank channel — degenerate clip; track from center
        return np.asarray(frame_channel.shape, dtype=np.float64) / 2.0
    return pix.mean(axis=0)


def greedy_track(clip: np.ndarray, hit_radius: float = 1.0):
    """Run the greedy tracker over one clip [T,H,W,C] uint8.

    Returns (pred, end_distance): pred is the binary answer (endpoint within
    hit_radius of the end marker), end_distance the final tracked-position →
    end-marker distance in pixels (the confidence signal: small = confident
    positive, large = confident negative).
    """
    clip = np.asarray(clip)
    pos = _marker_center(clip[0, :, :, 2])
    for t in range(clip.shape[0]):
        dots = np.argwhere(clip[t, :, :, 0] > 0)
        if dots.size == 0:
            continue
        pos = dots[np.linalg.norm(dots - pos, axis=1).argmin()].astype(np.float64)
    end = _marker_center(clip[-1, :, :, 2])
    dist = float(np.linalg.norm(end - pos))
    return int(dist <= hit_radius), dist


def greedy_response(clip: np.ndarray, hit_radius: float = 1.0,
                    scale: float = 2.0) -> float:
    """Per-clip response in (0, 1) shaped like an averaged human answer:
    ~0.95 when the tracked endpoint lands on the end marker, decaying with
    the endpoint distance (exp(-(d - hit_radius)+ / scale)), floored at 0.05.
    """
    _, dist = greedy_track(clip, hit_radius)
    p = float(np.exp(-max(dist - hit_radius, 0.0) / scale))
    return float(np.clip(p, 0.05, 0.95))


def greedy_accuracy_over_records(records, n: int | None = None,
                                 hit_radius: float = 1.0):
    """Accuracy of the greedy tracker over (clip, label) pairs.

    `records` is any iterable of (clip [T,H,W,C] uint8, label int) — e.g.
    pathtracker_torch.data.tfrecord.read_clip_records on a test shard.
    Returns (accuracy, n_seen).
    """
    correct = seen = 0
    for clip, label in records:
        if n is not None and seen >= n:
            break
        pred, _ = greedy_track(clip, hit_radius)
        correct += int(pred == int(label))
        seen += 1
    if seen == 0:
        raise ValueError("no records to score")
    return correct / seen, seen


def greedy_responses_for_shards(pattern: str, timesteps: int,
                                n_clips: int) -> np.ndarray:
    """Greedy-proxy responses for the first n_clips of the shards matching
    `pattern`, in the deterministic (shuffle_buffer=0) order the viz/eval
    loaders read them."""
    import glob as _glob

    from pathtracker_torch.data.tfrecord import read_clip_records

    out = []
    for path in sorted(_glob.glob(pattern)):
        for clip, _label in read_clip_records(path, timesteps=timesteps):
            out.append(greedy_response(clip))
            if len(out) >= n_clips:
                return np.asarray(out, dtype=np.float32)
    return np.asarray(out, dtype=np.float32)


def _main() -> None:
    import argparse
    import glob as _glob

    from pathtracker_torch.data.tfrecord import read_clip_records

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--glob", required=True,
                    help="TFRecord shard pattern, e.g. '.../tfrecords/test-*'")
    ap.add_argument("--n", type=int, default=1000,
                    help="clips to score (default 1000, the BASELINE.md bars)")
    ap.add_argument("--timesteps", type=int, default=None,
                    help="frames per clip (default: from the record shape)")
    ap.add_argument("--hit-radius", type=float, default=1.0)
    a = ap.parse_args()

    files = sorted(_glob.glob(a.glob))
    if not files:
        raise SystemExit(f"no shards match {a.glob}")

    def records():
        for path in files:
            yield from read_clip_records(path, timesteps=a.timesteps)

    acc, seen = greedy_accuracy_over_records(records(), n=a.n,
                                             hit_radius=a.hit_radius)
    print(f"greedy nearest-neighbor tracker: {acc:.4f} accuracy "
          f"over {seen} clips ({a.glob})")


if __name__ == "__main__":
    _main()
