#!/usr/bin/env python3
"""Where a training step's time goes in pathtracker_torch, on one CUDA card.

    python3 scripts/torch_train_profile.py

Takes warm batch-128, T=64 train steps (chainE weights, mixed bf16,
Adam(3e-4), rendered clips of dist 14, speed 1, 2-pixel dots) through
``make_train_step`` with the fused and the eager (recomputing) InT under
``torch.profiler`` and prints, per path: the step's wall time, the device's
busy time and share of the step's span, and device time by kernel group,
largest first, with the largest kernels by name.
"""

from __future__ import annotations

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from torch_serve_profile import CHECKPOINT, profile_call  # noqa: E402

from pathtracker_torch.data.pathtracker import render_batch  # noqa: E402
from pathtracker_torch.eval import serve  # noqa: E402
from pathtracker_torch.train.steps import make_optimizer, make_train_step  # noqa: E402

GROUPS = (  # first match wins; names are lower-cased
    ("fused K1-K3 backward", ("_bwd_kernel",)),
    ("fused K1-K3 forward (step + recompute)", ("k1_kernel", "k2_kernel", "k3_kernel")),
    ("conv backward-filter (cuDNN)", ("wgrad",)),
    ("conv backward-data (cuDNN)", ("dgrad",)),
    ("conv forward (cuDNN)", ("fprop", "conv", "cudnn", "xmma", "implicit")),
    ("matmul (cuBLAS)", ("gemm", "cublas", "cutlass")),
    ("Adam (foreach)", ("multi_tensor",)),
    ("reductions (BN statistics and their VJP, partial sums)", ("reduce",)),
    ("elementwise + copies", ("elementwise", "vectorized", "copy", "cat", "fill")),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    out = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
    print(out.strip().splitlines()[0])
    clips, labels = render_batch(0, 128, 64, n_distractors=14, dot_size=2)
    clips, labels = torch.from_numpy(clips).cuda(), torch.from_numpy(labels).cuda()
    for path, kw in (("fused", {}), ("eager", {"fused": False})):
        model = serve.build(ckpt=CHECKPOINT, length=64, bf16=True, **kw).train()
        step = make_train_step(model, "InT", make_optimizer(3e-4))
        print(f"{path} mixed InT train step, batch 128, T=64:")
        profile_call(lambda: step(clips, labels), GROUPS, top=14)
    return 0


if __name__ == "__main__":
    sys.exit(main())
