"""Dataset registry keyed on (dist, speed, length) (pathtracker_tpu/data/registry.py).

One layout rooted at ``$PATHTRACKER_DATA_ROOT`` (default ./datasets) in
place of the reference's cluster paths (reference utils/engine.py:343-404).
A config with no shards is rendered on demand by ``make_synthetic_dataset``,
so every entry point runs out of the box. The 8 evaluation configs are the
reference's ALL_DATASETS (reference utils/engine.py:31-40).
"""

from __future__ import annotations

import glob
import os

from pathtracker_torch.data.pathtracker import make_synthetic_dataset

ALL_DATASETS = [
    {"dist": 14, "speed": 1, "length": 64},
    {"dist": 14, "speed": 1, "length": 128},
    {"dist": 14, "speed": 1, "length": 32},
    {"dist": 14, "speed": 2, "length": 64},
    {"dist": 14, "speed": 4, "length": 64},
    {"dist": 0, "speed": 1, "length": 64},
    {"dist": 5, "speed": 1, "length": 64},
    {"dist": 25, "speed": 1, "length": 64},
]

# Human-experiment clip sets served by the attribution script (reference
# viz_model_att.py:144 calls engine.human_dataset_selector).
HUMAN_DATASETS = {
    "gen_1_25_64": {"dist": 25, "speed": 1, "length": 64},
    "gen_1_14_64": {"dist": 14, "speed": 1, "length": 64},
    "gen_1_5_64": {"dist": 5, "speed": 1, "length": 64},
    "gen_1_0_64": {"dist": 0, "speed": 1, "length": 64},
}


def data_root() -> str:
    return os.environ.get("PATHTRACKER_DATA_ROOT", os.path.abspath("datasets"))


def _config_dir(dist: int, speed: int, length: int, optical_flow: bool = False,
                root: str | None = None) -> str:
    stem = "tfrecords_optic_flow" if optical_flow else "tfrecords"
    return os.path.join(
        root or data_root(), f"pathtracker_{length}_32_32", f"{dist}_dist_speed_{speed}", stem
    )


def dataset_selector(dist: int, speed: int, length: int,
                     optical_flow: bool = False, synthesize_missing: bool = True,
                     synth_train: int | None = None, synth_test: int | None = None):
    """Return (tfrecord_dir, timesteps, len_train, len_test).

    The contract of reference utils/engine.py:345, which returned
    (path, timesteps, 20000, 20000). If the directory holds no train-*
    shards and ``synthesize_missing`` is set, a synthetic dataset is
    rendered there first ($PATHTRACKER_SYNTH_TRAIN/TEST clips, default
    512/512) from the seed ``hash((dist, speed, length)) % 2**31``.
    """
    root = _config_dir(dist, speed, length, optical_flow)
    if not glob.glob(os.path.join(root, "train-*")):
        if not synthesize_missing:
            raise FileNotFoundError(f"no TFRecords under {root}")
        n_train = synth_train or int(os.environ.get("PATHTRACKER_SYNTH_TRAIN", 512))
        n_test = synth_test or int(os.environ.get("PATHTRACKER_SYNTH_TEST", 512))
        make_synthetic_dataset(
            root,
            n_train=n_train,
            n_test=n_test,
            timesteps=length,
            n_distractors=dist,
            speed=speed,
            seed=hash((dist, speed, length)) % (2**31),
        )
    # Sizes come from a COUNTS file where one exists. Otherwise, as in the
    # JAX package: $PATHTRACKER_SYNTH_TRAIN (default 512) for both splits of
    # a root under the registry's layout, else the reference's nominal
    # 20000; the loaders do not need exact sizes.
    meta = os.path.join(root, "COUNTS")
    if os.path.exists(meta):
        with open(meta) as f:
            len_train, len_test = (int(v) for v in f.read().split())
    else:
        len_train = len_test = int(os.environ.get("PATHTRACKER_SYNTH_TRAIN", 512)) \
            if "pathtracker_" in root and os.path.exists(root) else 20000
    return root + os.sep, length, len_train, len_test


def human_dataset_selector(set_name: str):
    """Resolve a human-experiment set name to (tfrecord_dir, timesteps, ...)."""
    if set_name not in HUMAN_DATASETS:
        raise KeyError(f"unknown human set {set_name!r}; have {sorted(HUMAN_DATASETS)}")
    cfg = HUMAN_DATASETS[set_name]
    return dataset_selector(cfg["dist"], cfg["speed"], cfg["length"])


def get_datasets():
    return ALL_DATASETS
