"""Serving path: checkpoint -> model on the device -> inference function
-> exported program (pathtracker_tpu/eval/serve.py).

``make_inference_fn`` takes the WIRE format (uint8 [B,T,H,W,3] frames,
what the TFRecords carry) and returns per-clip scores: batch prep
(data/prepare.py), the model forward, and the sigmoid, on the model's
device. ``build`` turns a checkpoint into that model. ``export_program``
puts the same program through ``torch.export`` with a symbolic batch (or
a static one), and ``save_exported`` / ``load_exported`` write and read it
as a ``.pt2`` file.

Unlike the JAX package's StableHLO artifact, a ``.pt2`` is not free of
model code: where the fused cell serves (--bf16 at 32 channels), the
program calls the K1-K3 forward kernels as the custom ops
``torch.ops.pathtracker.*``, which ``load_exported`` registers by importing
``pathtracker_torch.ops.int_fused``. The artifact runs on the device it was
exported on.

    python -m pathtracker_torch.eval.serve --model InT --length 64 --bf16 \
        --ckpt <checkpoint> --out int64.pt2 --selftest-batch 8

Caveat inherited from the model: BatchNorm uses CURRENT-BATCH statistics
(the reference's ``track_running_stats=False``), so a clip's score depends
on its co-batched clips.
"""

from __future__ import annotations

import argparse
import os
from types import SimpleNamespace

import numpy as np
import torch
from torch import nn

from pathtracker_torch import engine
from pathtracker_torch.data.prepare import prepare_batch


class InferenceProgram(nn.Module):
    """uint8 [B,T,H,W,3] -> f32 [B] scores: prep, the forward, the sigmoid
    (or the raw logits). The module ``make_inference_fn`` calls and
    ``export_program`` exports."""

    def __init__(self, model, model_name: str, probs: bool = True,
                 pretrained_norm: bool = False):
        super().__init__()
        self.model, self.model_name = model, model_name
        self.probs, self.pretrained_norm = probs, pretrained_norm
        self.coord = engine.needs_coord_channels(model_name)

    def forward(self, raw):
        labels = torch.zeros((raw.shape[0],), dtype=torch.uint8, device=raw.device)
        imgs, _ = prepare_batch(raw, labels, pretrained_norm=self.pretrained_norm,
                                coord_channels=self.coord)
        logit = engine.model_step(self.model, imgs, self.model_name)[0][:, 0]
        return torch.sigmoid(logit) if self.probs else logit


def make_inference_fn(model, model_name: str, probs: bool = True,
                      pretrained_norm: bool = False):
    """uint8 [B,T,H,W,3] (tensor or array) -> f32 [B] scores on the model's
    device. probs=True applies the sigmoid; probs=False returns raw logits
    (the eval scripts' convention, thresholded at 0)."""
    program = InferenceProgram(model, model_name, probs, pretrained_norm)
    device = next(model.parameters()).device

    @torch.inference_mode()
    def infer(raw_imgs):
        return program(torch.as_tensor(raw_imgs).to(device))

    return infer


def export_program(model, model_name: str, timesteps: int, batch=None,
                   probs: bool = True, pretrained_norm: bool = False,
                   height: int = 32, width: int = 32):
    """``torch.export`` of the inference program on the model's device.
    ``batch=None`` makes the batch a symbolic dimension ``b``: one program
    serves any batch size; an int pins a static batch. The metadata asserts
    torch.export puts before each dtype cast are removed (see
    ``_drop_metadata_asserts``)."""
    device = next(model.parameters()).device
    program = InferenceProgram(model, model_name, probs, pretrained_norm)
    example = torch.zeros((2 if batch is None else int(batch), timesteps, height,
                           width, 3), dtype=torch.uint8, device=device)
    dynamic = {"raw": {0: torch.export.Dim("b", min=1)}} if batch is None else None
    with torch.no_grad():
        exported = torch.export.export(program, (example,), dynamic_shapes=dynamic)
    return _drop_metadata_asserts(exported)


def _drop_metadata_asserts(exported):
    """Remove the ``aten._assert_tensor_metadata`` node torch.export puts
    before each dtype cast (~29 a T step of InT), in place. Each re-checks,
    from Python at every call, a dtype the trace fixed; the program's inputs
    are still checked where it is called."""
    graph = exported.graph_module.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
    exported.graph_module.recompile()
    return exported


def save_exported(program, path: str) -> None:
    torch.export.save(program, path)


def load_exported(path: str):
    """A saved program as a callable: uint8 [B,T,H,W,3] tensor (or array)
    -> f32 [B]. Imports ``pathtracker_torch.ops.int_fused``, which registers
    the custom ops the program may call."""
    from pathtracker_torch.ops import int_fused  # noqa: F401  (registers the ops)

    module = torch.export.load(path).module()
    device = next((t.device for t in module.state_dict().values()), torch.device("cpu"))

    @torch.inference_mode()
    def served(raw_imgs):
        return module(torch.as_tensor(raw_imgs).to(device))

    return served


def build(model: str = "InT", ckpt: str | None = None, length: int = 64,
          dimensions: int = 32, fb_kernel_size: int = 7, bf16: bool = False,
          pretrained: bool = False, remat_blocks: bool = False,
          slowfast_cfg: str | None = None, device=None, **model_kwargs):
    """Model (any ``--model`` name the registry builds) for serving on
    ``device`` (``None`` means cuda), with the weights of ``ckpt`` (a
    checkpoint of either package, or a reference torch pickle) or, without
    one, its seeded init. ``slowfast_cfg`` is SlowFast's and ``slow``'s yaml
    (``--slowfast_cfg``); ``model_kwargs`` reach the model's constructor
    (e.g. ``fused=False`` for the eager cell or the plain correlation)."""
    args = SimpleNamespace(model=model, dimensions=dimensions,
                           fb_kernel_size=fb_kernel_size, bf16=bf16,
                           pretrained=pretrained, algo="bptt",
                           remat_blocks=remat_blocks, slowfast_cfg=slowfast_cfg)
    net = engine.model_selector(args, length, device=device, **model_kwargs)
    if ckpt:
        engine.load_ckpt(net, ckpt)
    return net.eval()


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Export a checkpoint as a torch.export serving program (.pt2)")
    p.add_argument("--model", default="InT")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint (msgpack of either package or reference torch .tar)")
    p.add_argument("--length", type=int, default=64, help="clip timesteps")
    p.add_argument("-d", "--dimensions", type=int, default=32)
    p.add_argument("-k", "--fb_kernel_size", type=int, default=7)
    p.add_argument("--slowfast_cfg", default=None,
                   help="SlowFast / slow yaml cfg (default: the model's own)")
    p.add_argument("--bf16", action="store_true",
                   help="export the mixed-precision fast path (bf16 matmul "
                        "operands, f32 state; the fused K1-K3 kernels at 32 "
                        "channels)")
    p.add_argument("--pretrained", action="store_true",
                   help="checkpoint was trained with --pretrained: bake the "
                        "Kinetics mean/std input normalization into the program")
    p.add_argument("--platforms", default=None,
                   help="accepted for the JAX package's command lines and "
                        "ignored: there is no platform to choose, the program "
                        "runs on the device it was exported on")
    p.add_argument("--batch", type=int, default=None,
                   help="static batch size (default: symbolic 'b')")
    p.add_argument("--logits", action="store_true",
                   help="emit raw logits instead of sigmoid probabilities")
    p.add_argument("--out", required=True, help="output program path (.pt2)")
    p.add_argument("--selftest-batch", type=int, default=0,
                   help="after export, load the program, run it on random "
                        "frames at this batch size and hold it to the live "
                        "model exactly")
    p.add_argument("--device", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    model = build(model=args.model, ckpt=args.ckpt, length=args.length,
                  dimensions=args.dimensions, fb_kernel_size=args.fb_kernel_size,
                  bf16=args.bf16, pretrained=args.pretrained,
                  slowfast_cfg=args.slowfast_cfg, device=args.device)
    program = export_program(model, args.model, args.length, batch=args.batch,
                             probs=not args.logits, pretrained_norm=args.pretrained)
    save_exported(program, args.out)
    print(f"exported {args.model} T={args.length} -> {args.out} "
          f"({os.path.getsize(args.out)} bytes, batch="
          f"{'symbolic' if args.batch is None else args.batch})")

    if args.selftest_batch:
        b = args.selftest_batch
        rng = np.random.default_rng(0)
        x = rng.integers(0, 255, (b, args.length, 32, 32, 3), dtype=np.uint8)
        got = load_exported(args.out)(x).cpu().numpy()
        want = make_inference_fn(model, args.model, probs=not args.logits,
                                 pretrained_norm=args.pretrained)(x).cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=0)
        print(f"selftest ok: program == live model at batch {b} "
              f"(scores {np.round(got[:4], 4)})")


if __name__ == "__main__":
    main()
