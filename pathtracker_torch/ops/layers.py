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


def _mixed_matmul(x, kernel, dtype, matmul):
    if x.is_cuda:
        return matmul(x.to(dtype), kernel.to(dtype))
    return matmul(x.to(dtype).float(), kernel.to(dtype).float()).to(dtype)


def _mixed_conv(x_nchw, weight, dtype, groups, conv):
    if x_nchw.is_cuda:
        return conv(x_nchw.to(dtype), weight.to(dtype), padding="same",
                    groups=groups)
    return conv(x_nchw.to(dtype).float(), weight.to(dtype).float(),
                padding="same", groups=groups).to(dtype)


def dense(x, kernel, bias=None, mxu_dtype=None, matmul=torch.matmul):
    """[..., Cin] @ [Cin, Cout] (+ bias). With ``mxu_dtype`` and an f32
    input, the mixed policy: the product takes one bf16 rounding and comes
    back as f32. ``matmul`` computes the product of the two operands as
    they are after the casts (the InT cell's remat passes its own)."""
    if mxu_dtype is not None and x.dtype == torch.float32:
        y = _mixed_matmul(x, kernel, mxu_dtype, matmul).float()
    else:
        y = matmul(x, kernel.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def conv2d(x, weight, bias=None, mxu_dtype=None, keep_mxu_dtype: bool = False,
           groups: int = 1, conv=F.conv2d):
    """'SAME' stride-1 conv of an NHWC ``x`` with an OIHW ``weight``
    ([O, I/groups, k, k]) -> NHWC. The NHWC tensor enters the conv as a
    channels-last NCHW view, so no copy is made on either side.

    A bf16 input, or ``mxu_dtype`` with an f32 input, takes the mixed path
    and yields bf16; ``keep_mxu_dtype=False`` upcasts an f32 input's result
    back to f32. ``conv`` is called as ``F.conv2d`` on the operands after
    the casts (the InT cell's remat passes its own)."""
    x_nchw = x.permute(0, 3, 1, 2)
    mixed = mxu_dtype is not None and x.dtype == torch.float32
    if mixed or x.dtype == torch.bfloat16:
        y = _mixed_conv(x_nchw, weight, mxu_dtype or x.dtype, groups, conv)
        if mixed and not keep_mxu_dtype:
            y = y.float()
    else:
        y = conv(x_nchw, weight.to(x.dtype), padding="same", groups=groups)
    y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _triple(v) -> tuple:
    return (v,) * 3 if isinstance(v, int) else tuple(v)


def _same_pads(size: int, k: int, stride: int, dilation: int) -> tuple[int, int]:
    """XLA's 'SAME' padding of one dimension: the output keeps ceil(size /
    stride) positions, and the odd extra element of padding goes high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def conv3d(x, weight, bias=None, stride=1, padding="SAME", dilation=1):
    """NTHWC conv of ``x`` with an OITHW ``weight`` -> NTHWC
    (pathtracker_tpu/ops/layers.py:120-141, THWIO there). ``padding`` is
    'SAME' (XLA's, as ``_same_pads``), an int, or one int per dimension
    (symmetric). A bf16 ``x`` runs the conv in bf16 with f32 accumulation
    and a bf16 output, emulated on the CPU as f32 math on the bf16
    operands, rounded once."""
    stride, dilation = _triple(stride), _triple(dilation)
    if padding == "SAME":
        pads = [_same_pads(n, k, s, d) for n, k, s, d in
                zip(x.shape[1:4], weight.shape[2:], stride, dilation)]
    else:
        pads = [(p, p) for p in _triple(padding)]
    # A contiguous NTHWC x is a channels_last_3d NCDHW view: oneDNN's fast
    # path on the CPU (an NCDHW-contiguous input takes a slow one there).
    x_ncdhw = x.contiguous().permute(0, 4, 1, 2, 3)
    if any(lo != hi for lo, hi in pads):
        x_ncdhw = F.pad(x_ncdhw, [p for lo_hi in reversed(pads) for p in lo_hi])
        pads = [(0, 0)] * 3
    args = (None, stride, [lo for lo, _ in pads], dilation)
    if x.dtype == torch.bfloat16 and not x.is_cuda:
        y = F.conv3d(x_ncdhw.float(), weight.to(x.dtype).float(), *args).to(x.dtype)
    else:
        y = F.conv3d(x_ncdhw, weight.to(x.dtype), *args)
    y = y.permute(0, 2, 3, 4, 1)
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


def layer_norm_2d(x, scale, bias, eps: float = 1e-5):
    """LayerNorm of NHWC ``x`` over each sample's (H, W, C), with ``scale``
    and ``bias`` laid out [H, W, C] (layers.py:165-172): torch's
    nn.LayerNorm([C, H, W]) on the NCHW view."""
    dims = tuple(range(1, x.dim()))
    mean = x.mean(dim=dims, keepdim=True)
    var = (x - mean).square().mean(dim=dims, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def avg_pool2d(x, window: int = 2):
    """'VALID' average pool of NHWC ``x``, stride = window (layers.py:188)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), window).permute(0, 2, 3, 1)


def max_pool3d(x, window: int = 2):
    """'VALID' max pool of NTHWC ``x`` over (T, H, W), stride = window: the
    models' ``lax.reduce_window(max)``."""
    return F.max_pool3d(x.permute(0, 4, 1, 2, 3), window).permute(0, 2, 3, 4, 1)


def avg_pool3d(x, window: int = 2):
    """'VALID' average pool of NTHWC ``x`` over (T, H, W), stride = window:
    the models' ``lax.reduce_window(add) / window**3``."""
    return F.avg_pool3d(x.permute(0, 4, 1, 2, 3), window).permute(0, 2, 3, 4, 1)


def max_pool2d(x, kernel: int = 3):
    """Stride-1 'SAME' max pool of an NHWC ``x`` (odd ``kernel``), the border
    padded with -inf: the TSM-ResNet stem's pool, which keeps the resolution
    (pathtracker_tpu/models/tsm_resnet.py:188-190)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel, stride=1, padding=kernel // 2)
    return y.permute(0, 2, 3, 1)


def global_avg_pool(x):
    """NHWC -> [N, C] spatial mean."""
    return x.mean(dim=(1, 2))
