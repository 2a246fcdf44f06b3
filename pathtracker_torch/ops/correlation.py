"""Spatial correlation (cost volume) and its gradients
(pathtracker_tpu/ops/correlation.py).

For each position of ``f1``, the dot product with ``f2`` over a
patch x patch neighbourhood of displacements, ``f2`` read as zero outside the
image, r = (patch - 1) // 2 * dilation:

    corr[n, y, x, dy*patch + dx] = sum_c f1[n,y,x,c] * f2[n, y+dy*dil-r, x+dx*dil-r, c]

The op is bilinear, so its two gradients are correlations of the cotangent
``g`` with the other input:

    df1[n, y, x, c]   = sum_d g[n,y,x,d] * f2[n, y+dy*dil-r, x+dx*dil-r, c]
    df2[n, y', x', c] = sum_d g[n,y,x,d] * f1[n,y,x,c],  y' = y+dy*dil-r, x' = x+dx*dil-r

Each of the three has a plain PyTorch version (``*_plain``) and a wrapper.
A wrapper checks its inputs, then takes the plain version for CPU tensors and
launches the hand-written CUDA kernel (csrc/correlation.cu) for CUDA tensors,
raising if the launch fails. ``<wrapper>.launches`` counts kernel launches
only. ``correlation`` is differentiable: given an input that requires grad
it goes through a ``torch.autograd.Function`` whose backward is the two
backward wrappers. The JAX package has a Pallas kernel for the forward only
and takes its gradient through the XLA formulation (correlation.py:109-114).

Layout: NHWC f32, contiguous; the volume is [N, H, W, patch*patch].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from pathtracker_torch.ops import _native


def l2_normalize(x, dim: int = -1, eps: float = 1e-6):
    """x / sqrt(sum(x^2) + eps) along ``dim`` (reference Matching_layer
    .L2normalize, resnet_TSM.py:152-157)."""
    return x / torch.sqrt(x.square().sum(dim=dim, keepdim=True) + eps)


# ----------------------------- plain versions -------------------------------

def _radius(patch: int, dilation: int) -> int:
    return (patch - 1) // 2 * dilation


def _windows(padded, h: int, w: int, patch: int, dilation: int):
    """The patch*patch shifted [N,h,w,C] views of a frame padded by r, in
    displacement order."""
    for dy in range(patch):
        for dx in range(patch):
            oy, ox = dy * dilation, dx * dilation
            yield padded[:, oy:oy + h, ox:ox + w, :]


def _pad(f, r: int):
    return F.pad(f, (0, 0, r, r, r, r))


def correlation_plain(f1, f2, patch: int = 15, dilation: int = 1):
    """Shift-and-reduce over the displacements, as ``correlation_xla``
    (correlation.py:36-47). f1, f2 [N,H,W,C] -> [N,H,W,patch*patch]."""
    _, h, w, _ = f1.shape
    f2p = _pad(f2, _radius(patch, dilation))
    return torch.stack([(f1 * win).sum(dim=-1)
                        for win in _windows(f2p, h, w, patch, dilation)], dim=-1)


def correlation_bwd_f1_plain(g, f2, patch: int = 15, dilation: int = 1):
    """g [N,H,W,patch*patch], f2 [N,H,W,C] -> df1 [N,H,W,C]."""
    _, h, w, _ = f2.shape
    f2p = _pad(f2, _radius(patch, dilation))
    df1 = torch.zeros_like(f2)
    for d, win in enumerate(_windows(f2p, h, w, patch, dilation)):
        df1 += g[..., d:d + 1] * win
    return df1


def correlation_bwd_f2_plain(g, f1, patch: int = 15, dilation: int = 1):
    """g [N,H,W,patch*patch], f1 [N,H,W,C] -> df2 [N,H,W,C]: each
    displacement's product added into the padded frame at its shift, and
    the frame cropped."""
    _, h, w, _ = f1.shape
    r = _radius(patch, dilation)
    df2p = _pad(torch.zeros_like(f1), r)
    for d, win in enumerate(_windows(df2p, h, w, patch, dilation)):
        win += g[..., d:d + 1] * f1
    return df2p[:, r:r + h, r:r + w, :].contiguous()


# -------------------------------- wrappers ----------------------------------

def _on_card(named, patch: int, dilation: int) -> bool:
    """Check the tensors ``named`` ({name: (tensor, channels)}, a feature map
    first; ``channels`` None means the first tensor's) and raise on anything
    the kernels do not take: f32, 4-D NHWC with positive sizes, contiguous,
    all on one device and of one [N,H,W]. True: CUDA tensors, launch the
    kernel. False: CPU tensors, take the plain version."""
    if not (isinstance(patch, int) and patch > 0 and patch % 2 == 1):
        raise ValueError(f"patch must be a positive odd int, got {patch!r}")
    if not (isinstance(dilation, int) and dilation >= 1):
        raise ValueError(f"dilation must be an int >= 1, got {dilation!r}")
    first = next(iter(named.values()))[0]
    for name, (t, last) in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected torch.float32, got {t.dtype}")
        if t.dim() != 4 or min(t.shape) <= 0:
            raise ValueError(f"{name}: expected a non-empty [N,H,W,C] tensor, "
                             f"got {tuple(t.shape)}")
        want = (*first.shape[:3], first.shape[3] if last is None else last)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: expected {want}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous (NHWC)")
        if t.device != first.device:
            raise ValueError(f"{name}: on {t.device}, expected {first.device}")
    device = first.device
    if device.type == "cuda":
        if device.index != torch.cuda.current_device():
            raise ValueError(f"tensors on {device}, but the current CUDA "
                             f"device is {torch.cuda.current_device()}")
        return True
    if device.type != "cpu":
        raise ValueError(f"no correlation implementation for {device}")
    return False


def _launch(fn, a, b, out, channels, patch, dilation):
    n, h, w, _ = a.shape
    _native.launch("correlation", fn, (a, b, out),
                   (n, h, w, channels, patch, dilation),
                   torch.cuda.current_stream().cuda_stream)
    return out


def _fwd_launch(f1, f2, patch, dilation):
    out = torch.empty((*f1.shape[:3], patch * patch), dtype=f1.dtype, device=f1.device)
    _launch("correlation_fwd", f1, f2, out, f1.shape[3], patch, dilation)
    correlation.launches += 1
    return out


def correlation_bwd_f1(g, f2, patch: int = 15, dilation: int = 1):
    """g [N,H,W,patch*patch], f2 [N,H,W,C] -> df1 [N,H,W,C], all f32."""
    if not _on_card({"f2": (f2, None), "g": (g, patch * patch)}, patch, dilation):
        return correlation_bwd_f1_plain(g, f2, patch, dilation)
    df1 = _launch("correlation_bwd_f1", g, f2, torch.empty_like(f2), f2.shape[3],
                  patch, dilation)
    correlation_bwd_f1.launches += 1
    return df1


def correlation_bwd_f2(g, f1, patch: int = 15, dilation: int = 1):
    """g [N,H,W,patch*patch], f1 [N,H,W,C] -> df2 [N,H,W,C], all f32."""
    if not _on_card({"f1": (f1, None), "g": (g, patch * patch)}, patch, dilation):
        return correlation_bwd_f2_plain(g, f1, patch, dilation)
    df2 = _launch("correlation_bwd_f2", g, f1, torch.empty_like(f1), f1.shape[3],
                  patch, dilation)
    correlation_bwd_f2.launches += 1
    return df2


class Correlation(torch.autograd.Function):
    """``correlation`` with the two backward wrappers as its backward."""

    @staticmethod
    def forward(ctx, f1, f2, patch, dilation):
        ctx.save_for_backward(f1, f2)
        ctx.patch, ctx.dilation = patch, dilation
        if f1.is_cuda:
            return _fwd_launch(f1, f2, patch, dilation)
        return correlation_plain(f1, f2, patch, dilation)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        g = g.contiguous()
        df1 = df2 = None
        if ctx.needs_input_grad[0]:
            df1 = correlation_bwd_f1(g, f2, ctx.patch, ctx.dilation)
        if ctx.needs_input_grad[1]:
            df2 = correlation_bwd_f2(g, f1, ctx.patch, ctx.dilation)
        return df1, df2, None, None


def correlation(f1, f2, patch: int = 15, dilation: int = 1):
    """f1, f2 [N,H,W,C] f32 -> the cost volume [N,H,W,patch*patch] f32."""
    on_card = _on_card({"f1": (f1, None), "f2": (f2, None)}, patch, dilation)
    if torch.is_grad_enabled() and (f1.requires_grad or f2.requires_grad):
        return Correlation.apply(f1, f2, patch, dilation)
    if on_card:
        return _fwd_launch(f1, f2, patch, dilation)
    return correlation_plain(f1, f2, patch, dilation)


KERNELS = (correlation, correlation_bwd_f1, correlation_bwd_f2)
for _k in KERNELS:
    _k.launches = 0
