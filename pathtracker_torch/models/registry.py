"""Model registry: name -> constructor (pathtracker_tpu/models/registry.py).

This slice of the port builds the InT family; every other reference
``--model`` name raises ``NotImplementedError`` naming the slice that ports
it. MODEL_FAMILY mirrors the three forward-contract families of the
reference's model_step (reference utils/engine.py:29-30,42-72):
  'recurrent'    forward(x) -> (logit, jv_penalty); testmode adds states/gates
  'torchvision'  forward(x) -> logit only
  'slowfast'     forward([slow, fast]) -> logit only
"""

from __future__ import annotations

import warnings
from typing import Any

MODEL_FAMILY = {
    "r3d": "torchvision",
    "mc3": "torchvision",
    "r2plus1": "torchvision",
    "nostride_r3d": "torchvision",
    "nostride_r3d_pos": "torchvision",
    "nostride_r3d_cc": "torchvision",
    "nostride_video_cc_small": "torchvision",
    "rntsm": "torchvision",
    "slowfast": "slowfast",
    "slowfast_nl": "slowfast",
    "slow": "torchvision",
}

# The seven InT names and their switches (pathtracker_tpu/models/registry.py:67-91).
INT_VARIANTS = {
    "InT": {},
    "InT_no_inh": {"no_inh": True},  # excitation-only circuit
    "InT_no_mult": {"lesion_alpha": True, "lesion_gamma": True},
    "InT_no_add": {"lesion_mu": True, "lesion_kappa": True},
    "InT_mult_add": {"lesion_gamma": True, "lesion_mu": True},
    "InT_only_add": {"lesion_alpha": True, "lesion_kappa": True},
    "InT_tanh": {"nl": "tanh"},
}

_RECURRENT_ZOO = ("fc", "hgru", "hgru_v2", "clock_hgru", "clock_hgru_fixed",
                  "gru", "convlstm", "stlstm", "fflstm", "lrcn", "lrcn_last",
                  "ffnet")
_FEEDFORWARD_ZOO = tuple(MODEL_FAMILY) + ("timesformer", "performer", "lambda")


def family(model_name: str) -> str:
    return MODEL_FAMILY.get(model_name, "recurrent")


def needs_coord_channels(model_name: str) -> bool:
    """Models whose stem takes 5 input channels (x + meshgrid coords
    appended by data prep, reference utils/engine.py:249-254).
    nostride_video_cc_small keeps '_cc' in its name but appends coords
    INSIDE forward, so prep must not."""
    return "_cc" in model_name and model_name != "nostride_video_cc_small"


def model_selector(model_name: str, timesteps: int, fb_kernel_size: int = 7,
                   dimensions: int = 32, pretrained: bool = False,
                   device=None, **kwargs: Any):
    """Build the model for a reference ``--model`` name on ``device``
    (``None`` means cuda)."""
    from pathtracker_torch.models import int_circuit

    if model_name in _RECURRENT_ZOO:
        raise NotImplementedError(
            f"{model_name!r} is not ported yet: the recurrent zoo comes with a "
            "later slice of pathtracker_torch (ROADMAP.md queue 1 item 11)")
    if model_name in _FEEDFORWARD_ZOO:
        raise NotImplementedError(
            f"{model_name!r} is not ported yet: the feedforward zoo comes with "
            "a later slice of pathtracker_torch (ROADMAP.md queue 1 item 12)")
    if model_name not in INT_VARIANTS:
        raise NotImplementedError(f"Model not found: {model_name!r}")
    if pretrained:
        warnings.warn(
            "--pretrained: no pretrained weights exist for "
            f"{model_name!r}; using the pretrained input normalization only.",
            stacklevel=2)
    return int_circuit.InT(dimensions=dimensions, timesteps=timesteps,
                           kernel_size=fb_kernel_size, device=device,
                           **INT_VARIANTS[model_name], **kwargs)
