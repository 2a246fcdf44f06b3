"""TSM-ResNet with MotionSqueeze optical flow
(pathtracker_tpu/models/tsm_resnet.py; reference models/resnet_TSM.py,
arXiv:2004.11347 MotionSqueeze + arXiv:1811.08383 TSM).

  * 2D ResNet over frames: stem conv7x7 + maxpool, both stride 1 (the
    reference keeps full resolution for 32x32 clips), four stages of
    residual blocks, all stride 1;
  * every block applies the temporal shift (1/8 of the channels a frame
    forward, 1/8 a frame backward) to its input before its first conv;
  * after layer2: MotionSqueeze — channel reduction to 64, L2 normalisation,
    patch x patch correlation between adjacent frames (ops/correlation.py,
    the hand-written CUDA kernels on the card), Gaussian-windowed
    soft-argmax to a 2-channel flow plus the top-1 confidence, then the
    depthwise/pointwise flow-refinement stack 3->16->32->64->C added
    residually to the layer2 features;
  * head: per-frame global average pool, a 1x1 fc to ``num_classes``, mean
    over frames (TSN consensus).

Numerics: f32 throughout (the JAX model has no dtype switch and its convs
run at Precision.HIGHEST; the port pins TF32 off). Every BatchNorm uses
current-batch statistics in train and eval, biased variance, eps 1e-5.

Modules are named after the reference's state_dict keys (``conv1``, ``bn1``,
``layerL.B.{convI,bnI,downsample.{0,1}}``, ``chnl_reduction.{0,1}``,
``flow_refinement.convN.{0,1,3,4}``, ``fc1`` with a Conv1d-shaped
[cls, C, 1] weight), with torch's own weight layouts (OIHW); activations
keep the JAX package's channels-last layout.

Contract: torchvision family — forward(x [B,C,T,H,W]) -> logits [B, num_classes].
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from pathtracker_torch import resolve_device
from pathtracker_torch.ops.correlation import (correlation, correlation_plain,
                                               l2_normalize)
from pathtracker_torch.ops.layers import batch_norm, conv2d, dense, max_pool2d
from pathtracker_torch.ops.tsm import tsm

BN_EPS = 1e-5  # torch BatchNorm2d's default, which the reference uses
WIDTHS = (64, 128, 256, 512)


class _Conv(nn.Module):
    """Bias-free 'SAME' stride-1 conv on NHWC with an OIHW ``weight``,
    kaiming-normal fan-out init (tsm_resnet.py:40-42)."""

    def __init__(self, cin, cout, kernel, groups, gen):
        super().__init__()
        self.groups = groups
        std = math.sqrt(2.0 / (cout * kernel * kernel))
        self.weight = nn.Parameter(std * torch.randn(
            (cout, cin // groups, kernel, kernel), generator=gen))

    def forward(self, x):
        return conv2d(x, self.weight, groups=self.groups)


class _BN(nn.Module):
    """Batch-statistics norm over NHWC's N, H, W (``weight`` ones, ``bias``
    zeros): BatchNorm2d without running statistics."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return batch_norm(x, self.weight, self.bias, eps=BN_EPS)


class _ConvBN(nn.Sequential):
    """conv (``0``) -> BN (``1``) -> optional ReLU, on NHWC (tsm_resnet.py:45-65)."""

    def __init__(self, cin, cout, kernel=1, groups=1, relu=True, *, gen):
        layers = [_Conv(cin, cout, kernel, groups, gen), _BN(cout)]
        super().__init__(*layers, *([nn.ReLU()] if relu else []))


def _frames(x):
    b, t, h, w, c = x.shape
    return x.reshape(b * t, h, w, c)


class _TSMBottleneck(nn.Module):
    """ResNet bottleneck (1x1, 3x3, 1x1 x4) with the temporal shift on the
    block input (tsm_resnet.py:68-92). [B,T,H,W,cin] -> [B,T,H,W,4*planes]."""

    expansion = 4

    def __init__(self, cin, planes, shift=True, *, gen):
        super().__init__()
        self.shift = shift
        cout = planes * 4
        self.conv1, self.bn1 = _Conv(cin, planes, 1, 1, gen), _BN(planes)
        self.conv2, self.bn2 = _Conv(planes, planes, 3, 1, gen), _BN(planes)
        self.conv3, self.bn3 = _Conv(planes, cout, 1, 1, gen), _BN(cout)
        if cin != cout:
            self.downsample = _ConvBN(cin, cout, 1, relu=False, gen=gen)

    def forward(self, x):
        y = _frames(tsm(x) if self.shift else x)
        y = torch.relu(self.bn1(self.conv1(y)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = _frames(x)
        if hasattr(self, "downsample"):
            res = self.downsample(res)
        return torch.relu(y + res).reshape(*x.shape[:4], -1)


class _TSMBasicBlock(nn.Module):
    """ResNet basic block (two 3x3 convs, expansion 1) with the temporal
    shift — the block of the resnet18/34 builders (tsm_resnet.py:95-118)."""

    expansion = 1

    def __init__(self, cin, planes, shift=True, *, gen):
        super().__init__()
        self.shift = shift
        self.conv1, self.bn1 = _Conv(cin, planes, 3, 1, gen), _BN(planes)
        self.conv2, self.bn2 = _Conv(planes, planes, 3, 1, gen), _BN(planes)
        if cin != planes:
            self.downsample = _ConvBN(cin, planes, 1, relu=False, gen=gen)

    def forward(self, x):
        y = _frames(tsm(x) if self.shift else x)
        y = torch.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        res = _frames(x)
        if hasattr(self, "downsample"):
            res = self.downsample(res)
        return torch.relu(y + res).reshape(*x.shape[:4], -1)


class _FlowRefinement(nn.Module):
    """Depthwise/pointwise conv stack 3 -> 16 -> 32 -> 64 -> out_channel,
    added residually (tsm_resnet.py:121-141). ``convN`` is the reference's
    Sequential: dw conv (0), BN (1), ReLU, pw conv (3), BN (4), ReLU."""

    def __init__(self, out_channel, *, gen):
        super().__init__()
        stages = ((3, 16, 7), (16, 32, 3), (32, 64, 3), (64, out_channel, 3))
        for i, (cin, cout, k) in enumerate(stages, start=1):
            setattr(self, f"conv{i}", nn.Sequential(
                _Conv(cin, cin, k, cin, gen), _BN(cin), nn.ReLU(),
                _Conv(cin, cout, 1, 1, gen), _BN(cout), nn.ReLU()))

    def forward(self, flow_conf, res):
        """flow_conf [B,T,H,W,3] (flow u, v + confidence), res
        [B,T,H,W,out_channel] -> res + refined flow features."""
        x = _frames(flow_conf)
        for i in range(1, 5):
            x = getattr(self, f"conv{i}")(x)
        return x.reshape(res.shape) + res


def _match_to_flow_soft(match, patch: int, temperature: float = 100.0,
                        sigma: float = 5.0):
    """Gaussian-windowed soft-argmax over the correlation volume
    (tsm_resnet.py:144-164). match [N,H,W,P*P] -> (flow [N,H,W,2] in
    [-1, 1], confidence [N,H,W,1]). ``argmax`` takes the first maximum, as
    ``jnp.argmax`` does."""
    n, h, w, pp = match.shape
    disp = (patch - 1) / 2.0
    conf = match.amax(dim=-1, keepdim=True)  # top-1 confidence
    idx = match.argmax(dim=-1, keepdim=True)  # [N,H,W,1]
    idx_y = (idx // patch).to(match.dtype)
    idx_x = (idx % patch).to(match.dtype)
    coords = torch.arange(pp, device=match.device)
    cx = (coords % patch).to(match.dtype)
    cy = (coords // patch).to(match.dtype)
    gauss = torch.exp(-((cx - idx_x) ** 2 + (cy - idx_y) ** 2) / (2 * sigma ** 2))
    weighted = torch.softmax(match * gauss * temperature, dim=-1)
    smax = weighted.reshape(n, h, w, patch, patch)  # [..., y, x]
    kern = torch.arange(patch, device=match.device, dtype=match.dtype) - disp
    flow_x = (smax.sum(dim=3) * kern).sum(dim=-1) / disp
    flow_y = (smax.sum(dim=4) * kern).sum(dim=-1) / disp
    return torch.stack([flow_x, flow_y], dim=-1), conf


class TSMResNet(nn.Module):
    """TSM-ResNet + MotionSqueeze (tsm_resnet.py:167-221).

    ``remat``: when a gradient is asked for, each residual block runs under
    ``torch.utils.checkpoint`` (non-reentrant), which keeps only the
    block's input and recomputes its activations in backward, as
    ``nn.remat(block_cls)`` does in the JAX model; gradients are the same
    either way. The MotionSqueeze is outside it, so the correlation runs
    once per forward.
    ``fused``: True sends the correlation to ``ops.correlation.correlation``
    (the CUDA kernels for CUDA tensors, their plain versions on the CPU);
    False takes the plain version wherever the tensors are. It exists to
    compare the two and is never chosen because a kernel failed.
    Parameters are drawn from ``torch.Generator().manual_seed(seed)`` and
    placed on ``device`` (``None`` means cuda).
    """

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), num_segments: int = 8,
                 flow_estimation: bool = True, num_classes: int = 1,
                 patch: int = 15, block: str = "bottleneck", remat: bool = False,
                 fused: bool = True, seed: int = 0, device=None):
        super().__init__()
        if block not in ("bottleneck", "basic"):
            raise ValueError(f"block must be 'bottleneck' or 'basic', got {block!r}")
        self.layers = tuple(layers)
        self.num_segments, self.flow_estimation = num_segments, flow_estimation
        self.num_classes, self.patch, self.block = num_classes, patch, block
        self.remat, self.fused = remat, fused
        block_cls = _TSMBottleneck if block == "bottleneck" else _TSMBasicBlock

        gen = torch.Generator().manual_seed(seed)
        self.conv1, self.bn1 = _Conv(3, 64, 7, 1, gen), _BN(64)
        c = 64
        for si, nblocks in enumerate(self.layers):
            stage = []
            for _ in range(nblocks):
                stage.append(block_cls(c, WIDTHS[si], gen=gen))
                c = WIDTHS[si] * block_cls.expansion
            setattr(self, f"layer{si + 1}", nn.Sequential(*stage))
            if si == 1 and flow_estimation:
                self.chnl_reduction = _ConvBN(c, 64, 1, gen=gen)
                self.flow_refinement = _FlowRefinement(c, gen=gen)
        self.fc1 = nn.utils.skip_init(nn.Conv1d, c, num_classes, 1)
        with torch.no_grad():
            self.fc1.weight.copy_(0.01 * torch.randn(self.fc1.weight.shape, generator=gen))
            self.fc1.bias.zero_()
        self.to(resolve_device(device))

    def forward(self, x, testmode: bool = False):
        xc = x.permute(0, 2, 3, 4, 1)  # [B,T,H,W,3]
        b, t, h, w, _ = xc.shape
        y = torch.relu(self.bn1(self.conv1(xc.reshape(b * t, h, w, 3))))
        y = max_pool2d(y, 3).reshape(b, t, h, w, 64)

        remat = self.remat and torch.is_grad_enabled()
        for si in range(len(self.layers)):
            for blk in getattr(self, f"layer{si + 1}"):
                y = checkpoint(blk, y, use_reentrant=False) if remat else blk(y)
            if si == 1 and self.flow_estimation:
                y = self._motion_squeeze(y)

        feat = y.mean(dim=(2, 3))  # [B,T,C]
        logits = dense(feat, self.fc1.weight[:, :, 0].t(), self.fc1.bias)
        return logits.mean(dim=1)  # TSN consensus over frames

    def _motion_squeeze(self, y):
        b, t, h, w, c = y.shape
        red = self.chnl_reduction(_frames(y)).reshape(b, t, h, w, 64)
        f_pre = l2_normalize(red[:, :-1].reshape(b * (t - 1), h, w, 64))
        f_post = l2_normalize(red[:, 1:].reshape(b * (t - 1), h, w, 64))
        corr = correlation if self.fused else correlation_plain
        match = torch.relu(corr(f_pre, f_post, self.patch))
        flow, conf = _match_to_flow_soft(match, self.patch)
        fc = torch.cat([flow, conf], dim=-1).reshape(b, t - 1, h, w, 3)
        fc = torch.cat([fc, fc[:, -1:]], dim=1)  # repeat last frame
        return self.flow_refinement(fc, y)


def resnet50_tsm(num_segments: int = 8, flow_estimation: bool = True,
                 pretrained: bool = False, **kwargs):
    """reference utils/engine.py:192 builds rntsm.resnet50(shift='TSM',
    num_segments=8, flow_estimation=1)."""
    return TSMResNet(num_segments=num_segments, flow_estimation=flow_estimation,
                     **kwargs)


def resnet18_tsm(num_segments: int = 8, flow_estimation: bool = True,
                 pretrained: bool = False, **kwargs):
    """reference resnet_TSM.py:448 — BasicBlock, [2,2,2,2]."""
    return TSMResNet(layers=(2, 2, 2, 2), block="basic", num_segments=num_segments,
                     flow_estimation=flow_estimation, **kwargs)


def resnet34_tsm(num_segments: int = 8, flow_estimation: bool = True,
                 pretrained: bool = False, **kwargs):
    """reference resnet_TSM.py:467 — BasicBlock, [3,4,6,3]."""
    return TSMResNet(layers=(3, 4, 6, 3), block="basic", num_segments=num_segments,
                     flow_estimation=flow_estimation, **kwargs)


def resnet101_tsm(num_segments: int = 8, flow_estimation: bool = True,
                  pretrained: bool = False, **kwargs):
    """reference resnet_TSM.py:505 — Bottleneck, [3,4,23,3]."""
    return TSMResNet(layers=(3, 4, 23, 3), block="bottleneck",
                     num_segments=num_segments, flow_estimation=flow_estimation,
                     **kwargs)
