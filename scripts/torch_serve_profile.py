#!/usr/bin/env python3
"""Where a serving request's time goes in pathtracker_torch, on one CUDA card.

    python3 scripts/torch_serve_profile.py [--model InT|rntsm|<a SlowFast or transformer name>]

Serves warm batch-128, T=64 requests of rendered clips (chainE weights,
dist 14, speed 1, 2-pixel dots) through the fused and the eager mixed InT
under ``torch.profiler`` and prints, per path: the request's wall time, the
device's busy time and share of the request's span, and device time by
kernel group, largest first, with the largest kernels by name.

With ``--model rntsm``: one warm request of 8 clips, T=64 through the f32
TSM-ResNet50 + MotionSqueeze (seeded init), the same profile, and the
request's device time by part of the model (CUDA events around the trunk's
convs, the trunk's BatchNorm passes and the whole MotionSqueeze; the rest is
shifts, ReLUs, residual adds, the pool, the head and batch prep).

With ``--model`` slowfast, slowfast_nl, slow, timesformer, performer or
lambda: one warm request of 32 clips, T=64 at the registry's width and
depth (f32, seeded init), the same profile.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pathtracker_torch.data.pathtracker import render_batch  # noqa: E402
from pathtracker_torch.eval import serve  # noqa: E402
from pathtracker_torch.models.registry import SLOWFAST, TRANSFORMERS  # noqa: E402

CHECKPOINT = os.path.join(ROOT, "results_conv", "64_1_14", "chainE", "saved_models",
                          "model_val_acc_0072_epoch_15_checkpoint.pth.tar")
GROUPS = (  # first match wins; names are lower-cased
    ("fused K1-K3", ("k1_kernel", "k2_kernel", "k3_kernel")),
    ("correlation kernels", ("corr_fwd_kernel", "corr_bwd_kernel")),
    # cuDNN's convs by their passes (an ``sm*_xmma_fprop_implicit_gemm``);
    # cuBLAS's products are ``sm*_xmma_gemm_*``, so "xmma" alone names no group.
    ("conv (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit")),
    ("matmul (cuBLAS)", ("gemm", "cublas", "cutlass")),
    ("reductions (BN stats, means)", ("reduce",)),
    ("elementwise + copies", ("elementwise", "vectorized", "copy", "cat", "fill")),
)


def _group(name: str, groups) -> str:
    low = name.lower()
    for group, keys in groups:
        if any(k in low for k in keys):
            return group
    return "other"


def profile_call(fn, groups=GROUPS, top: int = 8) -> None:
    """Run ``fn()`` once warm, then once under torch.profiler; print its wall
    time, the device's busy share of its span, and device time by group."""
    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        sys.exit("torch.profiler recorded no device kernels")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, spans[0][0]
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    span = spans[-1][1] - spans[0][0]
    by_group, by_name = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e in kernels:
        dur = e.time_range.elapsed_us()
        by_group[_group(e.name, groups)] += dur
        by_name[e.name][0] += dur
        by_name[e.name][1] += 1
    total = sum(by_group.values())
    print(f"  wall {wall_ms:.2f} ms; device busy {busy / 1e3:.2f} ms of a "
          f"{span / 1e3:.2f} ms span ({busy / span:.1%}); {len(kernels)} kernels")
    for group, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {group:30s} {us / 1e3:8.2f} ms  {us / total:6.1%}")
    print("  largest kernels:")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"    {us / 1e3:8.2f} ms  x{n:<5d} {name[:110]}")


def by_model_part(model, fn) -> None:
    """Device time of one warm ``fn()`` by part of a TSMResNet: CUDA events
    around every trunk conv, every trunk BatchNorm and the MotionSqueeze
    (whose own convs and BatchNorms count as MotionSqueeze)."""
    from pathtracker_torch.models import tsm_resnet

    events, state = [], {"inside": False}

    def timed(label, call):
        def wrapper(*args, **kwargs):
            if state["inside"] and label != "MotionSqueeze":
                return call(*args, **kwargs)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            state["inside"] = label == "MotionSqueeze"
            start.record()
            out = call(*args, **kwargs)
            end.record()
            state["inside"] = False
            events.append((label, start, end))
            return out
        return wrapper

    conv, bn, squeeze = (tsm_resnet._Conv.forward, tsm_resnet._BN.forward,
                         model._motion_squeeze)
    tsm_resnet._Conv.forward = timed("trunk convs (cuDNN f32)", conv)
    tsm_resnet._BN.forward = timed("trunk BatchNorm passes", bn)
    model._motion_squeeze = timed("MotionSqueeze", squeeze)
    try:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    finally:
        tsm_resnet._Conv.forward, tsm_resnet._BN.forward = conv, bn
        del model._motion_squeeze
    total = start.elapsed_time(end)
    parts = defaultdict(float)
    for label, a, b in events:
        parts[label] += a.elapsed_time(b)
    parts["rest (shifts, ReLUs, adds, pool, head, prep)"] = total - sum(parts.values())
    print(f"  by part of the model, {total:.2f} ms of device time between events:")
    for label, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"  {label:46s} {ms:8.2f} ms  {ms / total:6.1%}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("InT", "rntsm", *SLOWFAST, *TRANSFORMERS),
                        default="InT")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    out = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
    print(out.strip().splitlines()[0])
    if args.model in SLOWFAST + TRANSFORMERS:
        clips, _ = render_batch(0, 32, 64, n_distractors=14, dot_size=2)
        batch = torch.from_numpy(clips).cuda()
        infer = serve.make_inference_fn(serve.build(model=args.model, length=64), args.model)
        print(f"{args.model} (the registry's width and depth, f32, seeded init), "
              "32 clips, T=64:")
        profile_call(lambda: infer(batch))
        return 0
    if args.model == "rntsm":
        clips, _ = render_batch(0, 8, 64, n_distractors=14, dot_size=2)
        batch = torch.from_numpy(clips).cuda()
        model = serve.build(model="rntsm", length=64)
        infer = serve.make_inference_fn(model, "rntsm")
        print("rntsm (TSM-ResNet50 + MotionSqueeze, f32, seeded init), 8 clips, T=64:")
        profile_call(lambda: infer(batch))
        by_model_part(model, lambda: infer(batch))
        return 0
    clips, _ = render_batch(0, 128, 64, n_distractors=14, dot_size=2)
    batch = torch.from_numpy(clips).cuda()
    for path, kw in (("fused", {}), ("eager", {"fused": False})):
        model = serve.build(ckpt=CHECKPOINT, length=64, bf16=True, **kw)
        print(f"{path} mixed InT, batch 128, T=64:")
        infer = serve.make_inference_fn(model, "InT")
        profile_call(lambda: infer(batch))
    return 0


if __name__ == "__main__":
    sys.exit(main())
