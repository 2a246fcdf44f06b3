#!/usr/bin/env python3
"""Where a serving request's time goes in pathtracker_torch, on one CUDA card.

    python3 scripts/torch_serve_profile.py

Serves warm batch-128, T=64 requests of rendered clips (chainE weights,
dist 14, speed 1, 2-pixel dots) through the fused and the eager mixed InT
under ``torch.profiler`` and prints, per path: the request's wall time, the
device's busy time and share of the request's span, and device time by
kernel group, largest first, with the largest kernels by name.
"""

from __future__ import annotations

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

CHECKPOINT = os.path.join(ROOT, "results_conv", "64_1_14", "chainE", "saved_models",
                          "model_val_acc_0072_epoch_15_checkpoint.pth.tar")
GROUPS = (  # first match wins; names are lower-cased
    ("fused K1-K3", ("k1_kernel", "k2_kernel", "k3_kernel")),
    ("conv (cuDNN)", ("conv", "fprop", "cudnn", "xmma", "implicit")),
    ("matmul (cuBLAS)", ("gemm", "cublas", "cutlass")),
    ("reductions (BN stats, means)", ("reduce",)),
    ("elementwise + copies", ("elementwise", "vectorized", "copy", "cat", "fill")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def profile_path(infer, batch) -> None:
    infer(batch)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        infer(batch)
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
        by_group[_group(e.name)] += dur
        by_name[e.name][0] += dur
        by_name[e.name][1] += 1
    total = sum(by_group.values())
    print(f"  wall {wall_ms:.2f} ms; device busy {busy / 1e3:.2f} ms of a "
          f"{span / 1e3:.2f} ms span ({busy / span:.1%}); {len(kernels)} kernels")
    for group, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {group:30s} {us / 1e3:8.2f} ms  {us / total:6.1%}")
    print("  largest kernels:")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    {us / 1e3:8.2f} ms  x{n:<5d} {name[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    out = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
    print(out.strip().splitlines()[0])
    clips, _ = render_batch(0, 128, 64, n_distractors=14, dot_size=2)
    batch = torch.from_numpy(clips).cuda()
    for path, kw in (("fused", {}), ("eager", {"fused": False})):
        model = serve.build(ckpt=CHECKPOINT, length=64, bf16=True, **kw)
        print(f"{path} mixed InT, batch 128, T=64:")
        profile_path(serve.make_inference_fn(model, "InT"), batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
