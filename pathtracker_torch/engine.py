"""Engine: model selection from parsed flags and forward-family dispatch
(pathtracker_tpu/engine.py:33-129), for the families this slice ports.
"""

from __future__ import annotations

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
    if algo != "bptt":
        raise NotImplementedError(
            f"--algo {algo!r}: Neumann RBP comes with a later slice of "
            "pathtracker_torch (ROADMAP.md queue 1 item 8)")
    return _build(
        args.model,
        timesteps=timesteps,
        fb_kernel_size=getattr(args, "fb_kernel_size", 7),
        dimensions=getattr(args, "dimensions", 32),
        pretrained=getattr(args, "pretrained", False),
        device=device,
        **kwargs,
    )


def model_step(model, imgs, model_name: str, test: bool = False):
    """Forward dispatch (reference utils/engine.py:42-72). Returns
    (output, jv_penalty) or, with test=True, (output, states, gates)."""
    if family(model_name) != "recurrent":
        raise NotImplementedError(
            f"{model_name!r}: the {family(model_name)} forward family comes "
            "with the feedforward-zoo slice of pathtracker_torch")
    if test:
        return model(imgs, testmode=True)
    return model(imgs)
