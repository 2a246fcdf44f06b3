"""Engine: model selection from parsed flags and forward-family dispatch
(pathtracker_tpu/engine.py:33-129), for the families the port builds: the
recurrent InT family and, of the 'torchvision' family, ``rntsm``.
"""

from __future__ import annotations

import torch

from pathtracker_torch.models.registry import (family, needs_coord_channels,  # noqa: F401
                                               model_selector as _build)


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
