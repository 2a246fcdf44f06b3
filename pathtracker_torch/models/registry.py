"""Model registry: name -> constructor (pathtracker_tpu/models/registry.py).

The port builds the InT family, the linear probe ``fc``, the hGRU family
(``hgru``, ``hgru_v2``, ``clock_hgru``, ``clock_hgru_fixed``), the ConvGRU
``gru``, the legacy-contract ``convlstm``, the rest of the recurrent zoo
(``stlstm``, ``fflstm``, ``lrcn``, ``lrcn_last``, ``ffnet``), ``rntsm``
(TSM-ResNet50 with MotionSqueeze), the video ResNets (``r3d``, ``mc3``,
``r2plus1`` and the no-stride forks), SlowFast (``slowfast``,
``slowfast_nl``, ``slow``, from their yaml cfgs) and the transformers
(``timesformer``, ``performer``, ``lambda``). MODEL_FAMILY mirrors the three
forward-contract families of the reference's model_step (reference
utils/engine.py:29-30,42-72):
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

RECURRENT_ZOO = ("stlstm", "fflstm", "lrcn", "lrcn_last", "ffnet")
ZOO = ("fc", "hgru", "hgru_v2", "clock_hgru", "clock_hgru_fixed", "gru",
       "convlstm") + RECURRENT_ZOO
VIDEO_RESNETS = ("r3d", "mc3", "r2plus1", "nostride_r3d", "nostride_r3d_pos",
                 "nostride_r3d_cc", "nostride_video_cc_small")
# The torchvision trunks whose Kinetics weights train/loop.py's
# load_pretrained imports; --pretrained on any other name only selects the
# pretrained input normalization.
TORCHVISION_PRETRAINED = ("r3d", "mc3", "r2plus1")
SLOWFAST = ("slowfast", "slowfast_nl", "slow")
TRANSFORMERS = ("timesformer", "performer", "lambda")


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

    if model_name not in INT_VARIANTS and model_name not in (
            ZOO + VIDEO_RESNETS + SLOWFAST + TRANSFORMERS + ("rntsm",)):
        raise NotImplementedError(f"Model not found: {model_name!r}")
    if pretrained and model_name not in TORCHVISION_PRETRAINED:
        warnings.warn(
            "--pretrained: no pretrained weights exist for "
            f"{model_name!r}; using the pretrained input normalization only.",
            stacklevel=2)
    if model_name == "rntsm":
        from pathtracker_torch.models import tsm_resnet
        return tsm_resnet.resnet50_tsm(num_segments=8, flow_estimation=True,
                                       device=device, **kwargs)
    if model_name == "fc":
        return int_circuit.FC(dimensions=dimensions, timesteps=timesteps,
                              kernel_size=fb_kernel_size, device=device, **kwargs)
    if model_name in ("hgru", "hgru_v2", "clock_hgru", "clock_hgru_fixed"):
        from pathtracker_torch.models import hgru
        if model_name.startswith("clock_hgru"):
            kwargs["clock_type"] = "fixed" if model_name.endswith("_fixed") else "dynamic"
        cls = {"hgru": hgru.FFhGRU, "hgru_v2": hgru.FFhGRUv2}.get(model_name, hgru.ClockHGRU)
        return cls(dimensions=dimensions, timesteps=timesteps,
                   kernel_size=fb_kernel_size, device=device, **kwargs)
    if model_name == "gru":
        from pathtracker_torch.models import convgru
        # The reference doubles the width for the ConvGRU baseline
        # (reference utils/engine.py:148-153).
        return convgru.GRU(dimensions=dimensions * 2, timesteps=timesteps,
                           kernel_size=fb_kernel_size, device=device, **kwargs)
    if model_name == "convlstm":
        from pathtracker_torch.models import convlstm
        return convlstm.ConvLSTM(timesteps=timesteps, device=device, **kwargs)
    if model_name == "stlstm":
        from pathtracker_torch.models import stlstm
        return stlstm.FFSTLSTM(timesteps=timesteps, device=device, **kwargs)
    if model_name == "fflstm":
        from pathtracker_torch.models import fflstm
        return fflstm.FFLSTM(timesteps=timesteps, device=device, **kwargs)
    if model_name in ("lrcn", "lrcn_last"):
        from pathtracker_torch.models import lrcn
        cls = lrcn.LRCNStyle if model_name == "lrcn" else lrcn.LRCNStyleLast
        return cls(timesteps=timesteps, device=device, **kwargs)
    if model_name == "ffnet":
        from pathtracker_torch.models import ffnet
        # The JAX module reads the clip length from its input; a torch
        # module needs it for its Linear.
        return ffnet.FFConvNet(timesteps=timesteps, device=device, **kwargs)
    if model_name in VIDEO_RESNETS:
        from pathtracker_torch.models import video_resnet
        return video_resnet.build(model_name, timesteps=timesteps, device=device,
                                  **kwargs)
    if model_name in SLOWFAST:
        from pathtracker_torch.models import slowfast
        if model_name == "slow":
            # The PathTracker head, 1 logit, over the yaml's Kinetics-400
            # one (keyword arguments merge over the yaml).
            kwargs.setdefault("num_classes", 1)
        return slowfast.build(model_name, device=device, **kwargs)
    if model_name in TRANSFORMERS:
        from pathtracker_torch.models import transformers
        cls = {"timesformer": transformers.TransformerModel,
               "performer": transformers.PerformerModel,
               "lambda": transformers.LambdaModel}[model_name]
        return cls(dimensions=dimensions, timesteps=timesteps, device=device, **kwargs)
    return int_circuit.InT(dimensions=dimensions, timesteps=timesteps,
                           kernel_size=fb_kernel_size, device=device,
                           **INT_VARIANTS[model_name], **kwargs)
