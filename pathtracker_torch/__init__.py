"""PyTorch + CUDA port of pathtracker_tpu for NVIDIA Hopper (H100, sm_90a).

Module paths mirror pathtracker_tpu's, so every module has an obvious JAX
counterpart; the JAX package stays the reference the tests hold this one to.
The port imports torch and numpy only — never jax, flax, msgpack or
pathtracker_tpu — and keeps its own copies of what it needs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; they
raise when no card is present and CPU was not asked for.
"""

from __future__ import annotations

import torch

# Counterpart of Precision.HIGHEST (pathtracker_tpu/ops/layers.py:18-23): f32
# convolutions and matmuls run in full f32. cuDNN's default runs f32 convs in
# TF32, which keeps ~3 decimal digits and breaks the f32 parity path.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
# XLA accumulates bf16 products in f32; so must cuBLAS.
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises if a CUDA device is asked for and none
    is available: nothing in the port carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pathtracker_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev
