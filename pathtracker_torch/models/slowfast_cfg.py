"""fvcore-style yaml config surface for SlowFast
(pathtracker_tpu/models/slowfast_cfg.py).

The reference configured FAIR's SlowFast through yaml files (reference
models/cfgs/slowfast.yaml, loaded by models/slowfast_utils.py:13-17 via
slowfast.config.defaults + merge_from_file). ``--slowfast_cfg`` points at a
modified cfg and the model, and the engine's slow-pathway subsampling
(through ALPHA), follow it.

Only the keys that parameterise the architecture are read; the solver and
data-loader sections configure FAIR's training runner, which the train
loop's flags replace. Unknown keys are ignored, as fvcore's merge ignores
them. The default cfgs are the port's own copies under ``cfgs/``.
"""

from __future__ import annotations

import os

# R-depth -> bottleneck blocks per stage (torchvision/FAIR standard).
_DEPTH_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}

_CFG_DIR = os.path.join(os.path.dirname(__file__), "cfgs")

# The default cfgs mirror the reference's two variants; ``slowfast_nl`` gets
# its non-local locations applied for real (the reference's slowfast_nl()
# never merged its cfg, slowfast_utils.py:8-9).
DEFAULT_CFGS = {
    "slowfast": os.path.join(_CFG_DIR, "slowfast.yaml"),
    "slowfast_nl": os.path.join(_CFG_DIR, "slowfast_nl.yaml"),
    # Slow-only pathway: the reference ships models/cfgs/slow.yaml but no
    # model_selector name of its builds it; here `--model slow` does.
    "slow": os.path.join(_CFG_DIR, "slow.yaml"),
}


def load_slowfast_cfg(path: str) -> dict:
    """Parse a SlowFast yaml into ``SlowFast(**kwargs)`` keyword arguments.

    Mapping (yaml key -> model field):
      SLOWFAST.ALPHA                     -> alpha (also drives the engine's
                                            slow-pathway frame subsampling)
      SLOWFAST.BETA_INV                  -> beta_inv
      SLOWFAST.FUSION_CONV_CHANNEL_RATIO -> fusion_ratio
      SLOWFAST.FUSION_KERNEL_SZ          -> fusion_kernel
      RESNET.WIDTH_PER_GROUP             -> width
      RESNET.DEPTH                       -> stage_blocks (50/101/152)
      RESNET.SPATIAL_STRIDES[i][0]       -> stage_strides
      RESNET.ZERO_INIT_FINAL_BN          -> zero_init_final_bn
      NONLOCAL.LOCATION[i][0]            -> nonlocal_slow (slow pathway;
                                            fast-pathway NL is unused by both
                                            reference cfgs and unsupported)
      MODEL.NUM_CLASSES                  -> num_classes
      MODEL.DROPOUT_RATE                 -> dropout_rate
    """
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}

    def get(section: str, key: str, default):
        return (cfg.get(section) or {}).get(key, default)

    arch = str(get("MODEL", "ARCH", "slowfast")).lower()
    if arch not in ("slowfast", "slow"):
        raise ValueError(f"MODEL.ARCH {arch!r} unsupported "
                         f"('slowfast' or 'slow'): {path}")

    kwargs = {
        "arch": arch,
        "width": int(get("RESNET", "WIDTH_PER_GROUP", 64)),
        "num_classes": int(get("MODEL", "NUM_CLASSES", 1)),
        "dropout_rate": float(get("MODEL", "DROPOUT_RATE", 0.5)),
        "zero_init_final_bn": bool(get("RESNET", "ZERO_INIT_FINAL_BN", True)),
    }
    if arch == "slowfast":
        kwargs.update({
            "alpha": int(get("SLOWFAST", "ALPHA", 4)),
            "beta_inv": int(get("SLOWFAST", "BETA_INV", 8)),
            "fusion_ratio": int(
                get("SLOWFAST", "FUSION_CONV_CHANNEL_RATIO", 2)),
            "fusion_kernel": int(get("SLOWFAST", "FUSION_KERNEL_SZ", 7)),
        })

    depth = int(get("RESNET", "DEPTH", 50))
    if depth not in _DEPTH_BLOCKS:
        raise ValueError(
            f"RESNET.DEPTH {depth} unsupported (bottleneck depths "
            f"{sorted(_DEPTH_BLOCKS)}): {path}")
    kwargs["stage_blocks"] = _DEPTH_BLOCKS[depth]

    strides = get("RESNET", "SPATIAL_STRIDES", None)
    if strides is not None:
        try:
            kwargs["stage_strides"] = tuple(int(s[0]) for s in strides)
        except (TypeError, IndexError) as e:
            raise ValueError(
                "RESNET.SPATIAL_STRIDES must be a list of [slow, fast] "
                f"pairs (fvcore schema): {path}") from e

    nl = get("NONLOCAL", "LOCATION", None)
    if nl is not None:
        if arch == "slow":
            # Single-pathway schema: one block list per stage (reference
            # models/cfgs/slow.yaml NONLOCAL.LOCATION: [[[]], [[1,3]], ...]).
            try:
                slow_nl = [stage[0] for stage in nl]
            except (TypeError, IndexError) as e:
                raise ValueError(
                    "NONLOCAL.LOCATION must be a list of [blocks] entries "
                    f"per stage (single-pathway fvcore schema): {path}") from e
        else:
            try:
                slow_nl = [stage[0] for stage in nl]
                fast_nl = [stage[1] for stage in nl]
            except (TypeError, IndexError) as e:
                raise ValueError(
                    "NONLOCAL.LOCATION must be a list of [slow_blocks, "
                    f"fast_blocks] pairs per stage (fvcore schema): "
                    f"{path}") from e
            if any(fast_nl):
                raise ValueError(
                    f"fast-pathway NONLOCAL.LOCATION is not supported: {path}")
        try:
            # A flat per-stage list (e.g. LOCATION: [[1,3],[],[],[]]) makes
            # stage[0] above an int, which only surfaces here — keep the
            # error a schema ValueError naming the file, not a bare
            # TypeError from the int being non-iterable.
            kwargs["nonlocal_slow"] = tuple(tuple(int(b) for b in stage)
                                            for stage in slow_nl)
        except TypeError as e:
            raise ValueError(
                "NONLOCAL.LOCATION stages must be block LISTS per pathway "
                f"(fvcore schema, e.g. [[[1,3]], [[]], ...]): {path}") from e

    n_stages = len(kwargs["stage_blocks"])
    for key in ("stage_strides", "nonlocal_slow"):
        if key in kwargs and len(kwargs[key]) != n_stages:
            raise ValueError(
                f"{key} has {len(kwargs[key])} stages, model has {n_stages}:"
                f" {path}")
    return kwargs
