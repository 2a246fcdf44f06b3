"""Video ResNet family (pathtracker_tpu/models/video_resnet.py): torchvision
r3d_18 / mc3_18 / r2plus1d_18 and the reference's "no-stride" forks
(reference models/nostridetv.py, nostridetv_cc.py, nostridetv_cc_smallest.py,
nostridetv_positions.py).

Block convs: Conv3DSimple (3x3x3), Conv3DNoTemporal (1x3x3), Conv2Plus1D
(spatial 1x3x3 -> BN -> ReLU -> temporal 3x1x1 at the FLOP-matched
midplanes). BasicBlock: conv-BN-ReLU, conv-BN, + residual, ReLU.

Variants (``VARIANTS``):
  r3d / mc3 / r2plus1      torchvision: stem strided (1,2,2), stride-2
                           stages 2-4, a strided 1x1x1 downsample, global
                           average pool + fc (1 class);
  nostride_r3d             stem with stride 1 and dilation (1,2,2), widths
                           //4, stride-1 blocks whose downsample is a
                           dilated (2,2,2) 'SAME' conv;
  nostride_r3d_cc          5 input channels (coords from data prep), a
                           32-wide stem, widths //2 (//4 for stage 4);
  nostride_r3d_pos         5 channels: normalized meshgrid coords appended
                           in the forward, stride-1 stem;
  nostride_video_cc_small  constant 32-wide stages; readout from the last
                           frame's features and frame 0's blue channel
                           (the target marker): 5x5 conv to 1 channel and a
                           Linear over H*W.

Padding: strided convs pad torch-style, (k-1)//2 on both sides, which
places the windows where torchvision does; for stride 2 on even extents
XLA's 'SAME' would place them elsewhere. The no-stride forks keep 'SAME'.
Every BN uses batch statistics, eps 1e-5. ``dtype='bfloat16'`` runs the
whole net in bf16 (BN statistics in f32, logits returned in f32);
``'float64'`` runs it in f64, as the JAX module takes any dtype.

Modules carry torchvision's state_dict names (``stem.0``, ``stem.1``,
``layerL.B.convI.{0,1}``, ``layerL.B.convI.0.{0,1,3}`` for (2+1)D,
``layerL.B.downsample.{0,1}``, ``fc``) and torch's weight layouts (OITHW),
so a torchvision checkpoint is its own state_dict less the BN running
statistics; activations are channels-last (NTHWC).

Contract: torchvision family, ``forward(x [B,C,T,H,W]) -> logits [B, 1]``.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
from torch import nn

from pathtracker_torch import resolve_device
from pathtracker_torch.models.common import fill_
from pathtracker_torch.ops import initializers as init
from pathtracker_torch.ops.layers import batch_norm, conv2d, conv3d, dense

BN_EPS = 1e-5

VARIANTS: dict[str, dict[str, Any]] = {
    "r3d": dict(kinds=["simple"] * 4, widths=[64, 128, 256, 512], stem="basic",
                stem_out=64, in_ch=3, nostride=False, readout="fc"),
    "mc3": dict(kinds=["simple"] + ["no_temporal"] * 3, widths=[64, 128, 256, 512],
                stem="basic", stem_out=64, in_ch=3, nostride=False, readout="fc"),
    "r2plus1": dict(kinds=["2plus1"] * 4, widths=[64, 128, 256, 512], stem="r2plus1",
                    stem_out=64, in_ch=3, nostride=False, readout="fc"),
    "nostride_r3d": dict(kinds=["simple"] * 4, widths=[16, 32, 64, 128], stem="dilated",
                         stem_out=64, in_ch=3, nostride=True, readout="fc"),
    "nostride_r3d_cc": dict(kinds=["simple"] * 4, widths=[32, 64, 64, 128],
                            stem="dilated", stem_out=32, in_ch=5, nostride=True,
                            readout="fc"),
    "nostride_r3d_pos": dict(kinds=["simple"] * 4, widths=[16, 32, 64, 128],
                             stem="basic_nostride", stem_out=64, in_ch=5,
                             nostride=True, readout="fc", add_positions=True),
    "nostride_video_cc_small": dict(kinds=["simple"] * 4, widths=[32, 32, 32, 32],
                                    stem="basic_nostride", stem_out=32, in_ch=3,
                                    nostride=True, readout="target"),
}


class _Conv(nn.Module):
    """A bias-free conv3d on NTHWC with an OITHW ``weight``, kaiming-normal
    (fan_out, relu) init. ``padding`` None pads torch-style, (k-1)//2."""

    def __init__(self, cin, cout, kernel, gen, stride=(1, 1, 1), dilation=(1, 1, 1),
                 padding=None):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.padding = tuple((k - 1) // 2 for k in kernel) if padding is None else padding
        std = math.sqrt(2.0 / (cout * math.prod(kernel)))
        self.weight = nn.Parameter(std * torch.randn((cout, cin, *kernel), generator=gen))

    def forward(self, x):
        return conv3d(x, self.weight, stride=self.stride, padding=self.padding,
                      dilation=self.dilation)


class _BN(nn.Module):
    """Batch-statistics norm over NTHWC's N, T, H, W (``weight`` ones,
    ``bias`` zeros): BatchNorm3d without running statistics."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return batch_norm(x, self.weight, self.bias, eps=BN_EPS)


def _midplanes(cin, cout):
    return (cin * cout * 3 * 3 * 3) // (cin * 3 * 3 + 3 * cout)


def _block_conv(kind: str, cin: int, cout: int, stride: tuple, gen) -> nn.Module:
    """One conv_builder application (video_resnet.py:91-118)."""
    if kind == "simple":
        return _Conv(cin, cout, (3, 3, 3), gen, stride=stride)
    if kind == "no_temporal":
        return _Conv(cin, cout, (1, 3, 3), gen, stride=(1, *stride[1:]))
    mid = _midplanes(cin, cout)
    return nn.Sequential(_Conv(cin, mid, (1, 3, 3), gen, stride=(1, *stride[1:])),
                         _BN(mid), nn.ReLU(),
                         _Conv(mid, cout, (3, 1, 1), gen, stride=(stride[0], 1, 1)))


class _BasicBlock(nn.Module):
    def __init__(self, kind: str, cin: int, planes: int, stride: int, nostride: bool, gen):
        super().__init__()
        s = 1 if nostride else stride
        stride3 = (s, s, s) if kind != "no_temporal" else (1, s, s)
        self.conv1 = nn.Sequential(_block_conv(kind, cin, planes, stride3, gen),
                                   _BN(planes), nn.ReLU())
        self.conv2 = nn.Sequential(_block_conv(kind, planes, planes, (1, 1, 1), gen),
                                   _BN(planes))
        if stride != 1 or cin != planes:
            if nostride:  # a dilated 'SAME' conv keeps the resolution
                ds = (stride,) * 3
                conv = _Conv(cin, planes, ds, gen, dilation=ds, padding="SAME")
            else:
                ds = (stride,) * 3 if kind != "no_temporal" else (1, stride, stride)
                conv = _Conv(cin, planes, (1, 1, 1), gen, stride=ds)
            self.downsample = nn.Sequential(conv, _BN(planes))

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        res = self.downsample(x) if hasattr(self, "downsample") else x
        return torch.relu(y + res)


def _stem(cfg: dict, cin: int, gen) -> nn.Sequential:
    so = cfg["stem_out"]
    if cfg["stem"] == "r2plus1":
        return nn.Sequential(
            _Conv(cin, 45, (1, 7, 7), gen, stride=(1, 2, 2)), _BN(45), nn.ReLU(),
            _Conv(45, so, (3, 1, 1), gen), _BN(so), nn.ReLU())
    conv = {
        "basic": lambda: _Conv(cin, so, (3, 7, 7), gen, stride=(1, 2, 2)),
        # no stride, dilation (1,2,2); 'SAME' keeps the full 32x32 field
        "dilated": lambda: _Conv(cin, so, (3, 7, 7), gen, dilation=(1, 2, 2),
                                 padding="SAME"),
        "basic_nostride": lambda: _Conv(cin, so, (3, 7, 7), gen),
    }[cfg["stem"]]()
    return nn.Sequential(conv, _BN(so), nn.ReLU())


class VideoResNet(nn.Module):
    def __init__(self, variant: str = "r3d", num_classes: int = 1,
                 layers: Sequence[int] = (2, 2, 2, 2), timesteps: int | None = None,
                 dtype: str = "float32", height: int = 32, width: int = 32,
                 seed: int = 0, device=None):
        super().__init__()
        if dtype not in ("float32", "bfloat16", "float64"):
            raise ValueError(f"dtype must be 'float32', 'bfloat16' or 'float64', got {dtype!r}")
        cfg = self.cfg = VARIANTS[variant]
        self.variant = variant
        self.dtype = getattr(torch, dtype)
        gen = torch.Generator().manual_seed(seed)
        self.stem = _stem(cfg, cfg["in_ch"], gen)
        inplanes = cfg["stem_out"]
        for li, (kind, width_, nblocks) in enumerate(zip(cfg["kinds"], cfg["widths"], layers)):
            # torchvision's layer1 has stride 1 (the stem strides); the
            # no-stride forks give every layer stride 2, which there sets
            # the downsample's dilation.
            stride = 2 if (li > 0 or cfg["nostride"]) else 1
            blocks = []
            for bi in range(nblocks):
                blocks.append(_BasicBlock(kind, inplanes, width_, stride if bi == 0 else 1,
                                          cfg["nostride"], gen))
                inplanes = width_
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        if cfg["readout"] == "target":
            self.target_conv = nn.utils.skip_init(nn.Conv2d, inplanes + 1, 1, 5)
            fill_(self.target_conv.weight, init.torch_conv_default, gen)
            fill_(self.target_conv.bias, init.constant(0.0), gen)
            inplanes = height * width
        self.fc = nn.utils.skip_init(nn.Linear, inplanes, num_classes)
        fill_(self.fc.weight, init.normal(0.01), gen)
        fill_(self.fc.bias, init.constant(0.0), gen)
        self.to(resolve_device(device))

    def forward(self, x, testmode: bool = False):
        xc = x.permute(0, 2, 3, 4, 1).to(self.dtype)  # [B,T,H,W,C]
        if self.cfg.get("add_positions"):
            b, t, h, w, _ = xc.shape
            hh, ww = torch.meshgrid(torch.arange(h, dtype=xc.dtype, device=xc.device),
                                    torch.arange(w, dtype=xc.dtype, device=xc.device),
                                    indexing="ij")
            grid = torch.stack([ww, hh], -1) / max(h - 1, w - 1)
            xc = torch.cat([xc, grid.expand(b, t, h, w, 2)], dim=-1)

        y = self.stem(xc)
        for li in range(1, 5):
            y = getattr(self, f"layer{li}")(y)

        if self.cfg["readout"] == "target":
            merged = torch.cat([y[:, -1], xc[:, 0, :, :, 2:3]], dim=-1)
            out = conv2d(merged, self.target_conv.weight, self.target_conv.bias)
            feat = out.reshape(out.shape[0], -1)
        else:
            feat = y.mean(dim=(1, 2, 3))  # AdaptiveAvgPool3d((1,1,1))
        return dense(feat, self.fc.weight.t(), self.fc.bias).float()


def build(variant: str, timesteps: int | None = None, pretrained: bool = False,
          **kwargs):
    """The registry's constructor (video_resnet.py:279-284); ``num_classes``
    defaults to 1, as the reference's engine replaced the fc with a 1-unit
    head (reference utils/engine.py:188-190)."""
    return VideoResNet(variant=variant, timesteps=timesteps, **kwargs)
