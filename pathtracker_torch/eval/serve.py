"""Serving path: checkpoint -> model on the device -> inference function
(pathtracker_tpu/eval/serve.py:37-58,106-122).

``make_inference_fn`` takes the WIRE format (uint8 [B,T,H,W,3] frames,
what the TFRecords carry) and returns per-clip scores: batch prep
(data/prepare.py), the model forward, and the sigmoid, on the model's
device. ``build`` turns a checkpoint into that model.

Caveat inherited from the model: BatchNorm uses CURRENT-BATCH statistics
(the reference's ``track_running_stats=False``), so a clip's score depends
on its co-batched clips.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from pathtracker_torch import engine
from pathtracker_torch.data.prepare import prepare_batch


def make_inference_fn(model, model_name: str, probs: bool = True,
                      pretrained_norm: bool = False):
    """uint8 [B,T,H,W,3] (tensor or array) -> f32 [B] scores on the model's
    device. probs=True applies the sigmoid; probs=False returns raw logits
    (the eval scripts' convention, thresholded at 0)."""
    coord = engine.needs_coord_channels(model_name)
    device = next(model.parameters()).device

    @torch.inference_mode()
    def infer(raw_imgs):
        raw = torch.as_tensor(raw_imgs).to(device)
        labels = torch.zeros((raw.shape[0],), dtype=torch.uint8, device=device)
        imgs, _ = prepare_batch(raw, labels, pretrained_norm=pretrained_norm,
                                coord_channels=coord)
        logit = engine.model_step(model, imgs, model_name)[0][:, 0]
        return torch.sigmoid(logit) if probs else logit

    return infer


def build(model: str = "InT", ckpt: str | None = None, length: int = 64,
          dimensions: int = 32, fb_kernel_size: int = 7, bf16: bool = False,
          pretrained: bool = False, remat_blocks: bool = False, device=None,
          **model_kwargs):
    """Model (``InT`` family or ``rntsm``) for serving on ``device``
    (``None`` means cuda), with the weights of ``ckpt`` (a JAX-package
    msgpack checkpoint of that model) or, without one, its seeded init.
    ``model_kwargs`` reach the model's constructor (e.g. ``fused=False`` for
    the eager cell or the plain correlation)."""
    args = SimpleNamespace(model=model, dimensions=dimensions,
                           fb_kernel_size=fb_kernel_size, bf16=bf16,
                           pretrained=pretrained, algo="bptt",
                           remat_blocks=remat_blocks)
    net = engine.model_selector(args, length, device=device, **model_kwargs)
    if ckpt:
        engine.load_ckpt(net, ckpt)
    return net.eval()
