"""Engine: model selection from parsed flags, forward-family dispatch, batch
prep and checkpoint loading (pathtracker_tpu/engine.py), for the three
families: the recurrent family (InT, ``fc``, the hGRU family, ``gru``,
``stlstm``, ``fflstm``, ``lrcn``, ``lrcn_last``, ``ffnet`` and the
transformers), the 'torchvision' family (``rntsm``, the video ResNets and
``slow``) and the 'slowfast' family (``slowfast``, ``slowfast_nl``). The
reference-compatible API of reference utils/engine.py:
model_selector, model_step, prepare_data, dataset_selector, get_datasets,
load_ckpt, plot_results, and the APIs its viz script called but its
snapshot never defined (fix_model_name, human_dataset_selector).
"""

from __future__ import annotations

import numpy as np
import torch

from pathtracker_torch import resolve_device
from pathtracker_torch.data.prepare import prepare_batch
from pathtracker_torch.data.registry import (  # noqa: F401  (re-exported API)
    ALL_DATASETS,
    dataset_selector,
    get_datasets,
    human_dataset_selector,
)
from pathtracker_torch.models.registry import (MODEL_FAMILY, family,  # noqa: F401
                                               needs_coord_channels,
                                               model_selector as _build)
from pathtracker_torch.train.checkpoint import load_params
from pathtracker_torch.train.torch_import import (layout_of, state_dict_from_jax,
                                                  to_jax_params)

SLOWFAST_ALPHA = 4  # slow pathway takes every 4th frame (reference utils/engine.py:52)
DROPOUT_MODELS = ("slowfast", "slowfast_nl", "slow")  # dropout before the head


def model_selector(args, timesteps: int, device=None, **model_kwargs):
    """Build a model from parsed args (reference utils/engine.py:75-217) on
    ``device`` (``None`` means cuda); ``model_kwargs`` reach its constructor."""
    kwargs = dict(model_kwargs)
    if args.model == "convlstm":
        # ConvLSTM keeps the reference's legacy direct-call contract (a
        # static [B,1,H,W] image in, [B,2,H,W] out, the criterion inside;
        # reference convlstm.py:116), as in the JAX package
        # (pathtracker_tpu/engine.py:35-47).
        raise NotImplementedError(
            "'convlstm' uses the reference's legacy direct-call contract "
            "(static image -> [B,2,H,W]; reference convlstm.py:116) and is "
            "not trainable through the video CLI — build it via "
            "pathtracker_torch.models.registry.model_selector('convlstm')")
    if getattr(args, "bf16", False) and (
            args.model.startswith(("InT", "r3d", "mc3", "r2plus1", "nostride"))
            or args.model in ("hgru", "hgru_v2", "clock_hgru",
                              "clock_hgru_fixed", "gru")):
        # bfloat16 fast path: recurrent trackers use mixed precision (bf16
        # matmul operands, f32 state).
        kwargs["dtype"] = "bfloat16"
    algo = getattr(args, "algo", "bptt")
    if algo != "bptt" and family(args.model) == "recurrent":
        # As the JAX package (engine.py:56-69): --algo matters in the
        # recurrent family only, and 'rbp' only for InT*; every other value
        # ('Testing', set by the eval scripts) trains with BPTT.
        if "rbp" in algo and not args.model.startswith("InT"):
            raise NotImplementedError(
                f"--algo {algo!r} is implemented for InT*; "
                f"{args.model!r} trains with bptt")
        kwargs["grad_method"] = algo
    if getattr(args, "remat_blocks", False):
        # Per-residual-block rematerialization for rntsm, whose no-stride
        # trunk keeps full 32x32 maps through 1024/2048-wide stages: without
        # it a T=64 batch's backprop residuals do not fit the device.
        if args.model != "rntsm":
            raise NotImplementedError(
                f"--remat-blocks is wired for 'rntsm'; {args.model!r} fits "
                "without it (the InT family recomputes its steps already)")
        kwargs["remat"] = True
    if family(args.model) == "slowfast" or args.model == "slow":
        # The yaml is SlowFast's config surface (reference models/cfgs/*.yaml
        # via slowfast_utils.py:13-17): --slowfast_cfg points at a modified
        # cfg, else the default for the name is read.
        kwargs["cfg_path"] = getattr(args, "slowfast_cfg", None)
    return _build(
        args.model,
        timesteps=timesteps,
        fb_kernel_size=getattr(args, "fb_kernel_size", 7),
        dimensions=getattr(args, "dimensions", 32),
        pretrained=getattr(args, "pretrained", False),
        device=device,
        **kwargs,
    )


def model_step(model, imgs, model_name: str, test: bool = False,
               generator=None):
    """Forward dispatch (reference utils/engine.py:42-72). Returns
    (output, jv_penalty) or, with test=True, (output, states, gates).
    ``generator`` is the train step's: it reaches the models with
    stochastic layers (SlowFast's and ``slow``'s dropout, which runs only
    when one is given); the others have none. The 'torchvision' and
    'slowfast' families' forwards return the logits only: their penalty is
    ones(1), their states and gates None, and so are those of the recurrent
    models whose testmode returns no maps (stlstm, fflstm, lrcn, lrcn_last,
    ffnet: (logit, penalty), where the JAX package's eval fails to unpack
    them). The 'slowfast' family takes ``slowfast_pathways(imgs, alpha)``
    with the model's own alpha (its yaml's)."""
    fam = family(model_name)
    if fam in ("torchvision", "slowfast"):
        kw = {"generator": generator} if model_name in DROPOUT_MODELS else {}
        if fam == "slowfast":
            output = model(slowfast_pathways(imgs, getattr(model, "alpha", SLOWFAST_ALPHA)),
                           **kw)
        else:
            output = model(imgs, **kw)
        if test:
            return output, None, None
        return output, torch.ones((1,), dtype=torch.float32, device=output.device)
    if test:
        out = model(imgs, testmode=True)
        return out if len(out) == 3 else (out[0], None, None)
    return model(imgs)


def slowfast_pathways(imgs, alpha: int = SLOWFAST_ALPHA):
    """[slow, fast] pathway list (reference utils/engine.py:47-61): fast = all
    frames; slow = T//alpha frames taken at linspace(0, T-1, T//alpha)
    rounded down, as the reference's torch.index_select. The frame indices
    are computed on the device as numpy's linspace computes them (i * step
    in float64, the last set to T-1): no host copy, so the split also runs
    inside a CUDA graph capture (the resident windows)."""
    t = imgs.shape[2]
    n = t // alpha
    idx = torch.arange(n, dtype=torch.float64, device=imgs.device)
    if n > 1:
        idx = idx * ((t - 1) / (n - 1))
        idx[-1:].fill_(t - 1)  # a fill kernel: no host copy
    return [torch.index_select(imgs, 2, idx.long()), imgs]


def prepare_data(imgs, target, args, device=None, disentangle_channels: bool = False,
                 use_augmentations: bool = False):
    """Batch prep (reference utils/engine.py:220-255) on ``device`` (``None``
    means cuda): uint8 [B,T,H,W,3] clips and byte labels in, (f32
    [B,C,T,H,W], f32 [B]) out. ``use_augmentations`` is accepted and
    unused, as in the reference."""
    dev = resolve_device(device)
    return prepare_batch(
        torch.as_tensor(np.asarray(imgs)).to(dev),
        torch.as_tensor(np.asarray(target)).to(dev),
        disentangle_channels=disentangle_channels,
        pretrained_norm=getattr(args, "pretrained", False),
        coord_channels=needs_coord_channels(getattr(args, "model", "")),
    )


def load_ckpt(model, model_path: str, strict: bool = True):
    """Load a checkpoint into ``model`` in place and return it (reference
    utils/engine.py:258-269): a JAX-package (or the port's own) msgpack
    checkpoint, or a reference torch pickle, imported by layout.
    ``strict=False`` (the mode the reference viz script wanted) keeps the
    model's own values for parameters the checkpoint lacks and ignores the
    ones it has extra."""
    state = model.state_dict()
    params = load_params(model_path, template=lambda: to_jax_params(state),
                         strict=strict)
    model.load_state_dict(state_dict_from_jax(layout_of(state), params), strict=strict)
    return model


def fix_model_name(name: str) -> str:
    """Normalize run names to model names (reference viz_model_att.py:119):
    strips trailing run qualifiers like 'InT_run2'."""
    for known in sorted(MODEL_FAMILY, key=len, reverse=True):
        if name.startswith(known):
            return known
    for known in ("InT_no_inh", "InT_no_mult", "InT_no_add", "InT_mult_add",
                  "InT_only_add", "InT_tanh", "InT", "hgru_v2", "hgru", "gru",
                  "fc", "ffnet", "convlstm", "stlstm", "fflstm", "lrcn_last",
                  "lrcn", "performer", "timesformer", "lambda"):
        if name.startswith(known):
            return known
    return name


def plot_results(states, imgs, target, output, timesteps, gates=None,
                 prep_gifs=False, results_folder=None, show_fig=False):
    """Per-timestep Img/Attn/Activity panels and GIFs
    (reference utils/engine.py:272-340); imports matplotlib and imageio."""
    from pathtracker_torch.eval.plots import plot_results as _plot

    return _plot(states, imgs, target, output, timesteps, gates=gates,
                 prep_gifs=prep_gifs, results_folder=results_folder,
                 show_fig=show_fig)
