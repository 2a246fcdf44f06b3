"""Engine: model selection from parsed flags, forward-family dispatch, batch
prep and checkpoint loading (pathtracker_tpu/engine.py), for the families
the port builds: the recurrent InT family and, of the 'torchvision' family,
``rntsm``. The reference-compatible API of reference utils/engine.py:
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
from pathtracker_torch.train.torch_import import state_dict_from_jax

SLOWFAST_ALPHA = 4  # slow pathway takes every 4th frame (reference utils/engine.py:52)


def model_selector(args, timesteps: int, device=None, **model_kwargs):
    """Build a model from parsed args (reference utils/engine.py:75-217) on
    ``device`` (``None`` means cuda); ``model_kwargs`` reach its constructor."""
    kwargs = dict(model_kwargs)
    if getattr(args, "bf16", False) and (
            args.model.startswith(("InT", "r3d", "mc3", "r2plus1", "nostride"))
            or args.model in ("hgru", "hgru_v2", "clock_hgru",
                              "clock_hgru_fixed", "gru")):
        # bfloat16 fast path: recurrent trackers use mixed precision (bf16
        # matmul operands, f32 state).
        kwargs["dtype"] = "bfloat16"
    algo = getattr(args, "algo", "bptt")
    if "rbp" in algo and family(args.model) == "recurrent":
        # As the JAX package: --algo matters in the recurrent family only,
        # and 'rbp' only for InT*. The port's InT has no grad_method: every
        # other value ('Testing', set by the eval scripts) trains with BPTT.
        if not args.model.startswith("InT"):
            raise NotImplementedError(
                f"--algo {algo!r} is implemented for InT*; "
                f"{args.model!r} trains with bptt")
        raise NotImplementedError(
            f"--algo {algo!r}: Neumann RBP comes with a later slice of "
            "pathtracker_torch (ROADMAP.md queue 1 item 8)")
    if getattr(args, "remat_blocks", False):
        # Per-residual-block rematerialization for rntsm, whose no-stride
        # trunk keeps full 32x32 maps through 1024/2048-wide stages: without
        # it a T=64 batch's backprop residuals do not fit the device.
        if args.model != "rntsm":
            raise NotImplementedError(
                f"--remat-blocks is wired for 'rntsm'; {args.model!r} fits "
                "without it (the InT family recomputes its steps already)")
        kwargs["remat"] = True
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
    ``generator`` is the train step's, for models with stochastic layers;
    the ported models have none and ignore it. The 'torchvision' family's
    forward returns the logits only: its penalty is ones(1), its states and
    gates None."""
    fam = family(model_name)
    if fam == "torchvision":
        output = model(imgs)
        if test:
            return output, None, None
        return output, torch.ones((1,), dtype=torch.float32, device=output.device)
    if fam != "recurrent":
        raise NotImplementedError(
            f"{model_name!r}: the {fam} forward family comes with a later "
            "slice of pathtracker_torch")
    if test:
        return model(imgs, testmode=True)
    return model(imgs)


def slowfast_pathways(imgs, alpha: int = SLOWFAST_ALPHA):
    """[slow, fast] pathway list (reference utils/engine.py:47-61): fast = all
    frames; slow = T//alpha frames taken at linspace(0, T-1, T//alpha)
    rounded down, as the reference's torch.index_select."""
    t = imgs.shape[2]
    idx = np.linspace(0, t - 1, t // alpha).astype(np.int64)
    slow = torch.index_select(imgs, 2, torch.as_tensor(idx, device=imgs.device))
    return [slow, imgs]


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
    """Load a JAX-package checkpoint into ``model`` in place and return it
    (reference utils/engine.py:258-269). ``strict=False`` (the mode the
    reference viz script wanted) keeps the model's own values for
    parameters the checkpoint lacks and ignores the ones it has extra."""
    from pathtracker_torch.models.tsm_resnet import TSMResNet

    name = "rntsm" if isinstance(model, TSMResNet) else "InT"
    model.load_state_dict(state_dict_from_jax(name, load_params(model_path)),
                          strict=strict)
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
