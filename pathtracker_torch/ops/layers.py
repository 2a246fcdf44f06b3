"""Functional NN primitives with the reference's torch numerics, NHWC layout
(pathtracker_tpu/ops/layers.py).

Activations keep the JAX package's channels-last layout so the two packages
compare like with like; weights keep torch's own layouts (OIHW convs), since
the port's parameters are the reference ``state_dict``.

Mixed policy (``mxu_dtype=torch.bfloat16``): operands are rounded to bf16,
products accumulate in f32, and the OUTPUT takes one rounding to bf16
(layers.py:73-75, :111-114). On CUDA that is what a bf16 ``torch.matmul`` or
``F.conv2d`` gives (f32 accumulation is pinned in ``pathtracker_torch``).
On the CPU it is emulated exactly: f32 math on bf16-rounded operands, then
one rounding of the output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def softplus(x):
    """Thresholded softplus, log1p(exp(x)) with the x > 20 passthrough
    (layers.py:48-54) — exactly ``F.softplus``'s default form."""
    return F.softplus(x)


def _mixed_matmul(x, kernel, dtype):
    if x.is_cuda:
        return x.to(dtype) @ kernel.to(dtype)
    return (x.to(dtype).float() @ kernel.to(dtype).float()).to(dtype)


def _mixed_conv(x_nchw, weight, dtype):
    if x_nchw.is_cuda:
        return F.conv2d(x_nchw.to(dtype), weight.to(dtype), padding="same")
    return F.conv2d(x_nchw.to(dtype).float(), weight.to(dtype).float(),
                    padding="same").to(dtype)


def dense(x, kernel, bias=None, mxu_dtype=None):
    """[..., Cin] @ [Cin, Cout] (+ bias). With ``mxu_dtype`` and an f32
    input, the mixed policy: the product takes one bf16 rounding and comes
    back as f32."""
    if mxu_dtype is not None and x.dtype == torch.float32:
        y = _mixed_matmul(x, kernel, mxu_dtype).float()
    else:
        y = x @ kernel.to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def conv2d(x, weight, bias=None, mxu_dtype=None, keep_mxu_dtype: bool = False):
    """'SAME' stride-1 conv of an NHWC ``x`` with an OIHW ``weight`` ->
    NHWC. The NHWC tensor enters the conv as a channels-last NCHW view, so
    no copy is made on either side.

    A bf16 input, or ``mxu_dtype`` with an f32 input, takes the mixed path
    and yields bf16; ``keep_mxu_dtype=False`` upcasts an f32 input's result
    back to f32."""
    x_nchw = x.permute(0, 3, 1, 2)
    mixed = mxu_dtype is not None and x.dtype == torch.float32
    if mixed or x.dtype == torch.bfloat16:
        y = _mixed_conv(x_nchw, weight, mxu_dtype or x.dtype)
        if mixed and not keep_mxu_dtype:
            y = y.float()
    else:
        y = F.conv2d(x_nchw, weight.to(x.dtype), padding="same")
    y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def batch_norm(x, scale, bias, eps: float = 1e-3):
    """Batch-statistics norm over all axes but the last (channel) axis:
    biased variance E[x²]−E[x]², statistics in f32 (layers.py:144-162)."""
    dims = tuple(range(x.dim() - 1))
    xs = x.float()
    mean = xs.mean(dim=dims)
    mean2 = xs.square().mean(dim=dims)
    inv = torch.rsqrt(mean2 - mean.square() + eps)
    return ((x - mean.to(x.dtype)) * (inv.to(x.dtype) * scale.to(x.dtype))
            + bias.to(x.dtype))


def global_avg_pool(x):
    """NHWC -> [N, C] spatial mean."""
    return x.mean(dim=(1, 2))
