"""SlowFast networks (arXiv:1812.03982; pathtracker_tpu/models/slowfast.py,
reference models/slowfast_utils.py with models/cfgs/slowfast.yaml and
slowfast_nl.yaml).

The architecture comes from the yaml (slowfast_cfg.py): ALPHA 4, BETA_INV
8, FUSION_CONV_CHANNEL_RATIO 2, FUSION_KERNEL_SZ 7 (5 for _nl), R50
bottlenecks [3,4,6,3], spatial strides [1,2,2,2], slow temporal kernels
only in res4/res5 ([1,1,3,3]), dropout 0.5 before the head; ``slowfast_nl``
adds dot-product non-local blocks on the slow pathway at res3 [1,3] and
res4 [1,3,5]. ``SlowOnly`` is the slow pathway alone (cfgs/slow.yaml).

Every conv pads symmetrically by k//2 per dimension, as FAIR's Conv3d
modules do (for the strided convs, the fuse conv's temporal stride alpha
and the (1,3,3) stride-2 convs, XLA's 'SAME' would place the windows
elsewhere); every BN uses batch statistics with eps 1e-5. The final BN of
each bottleneck and the non-local block's output BN start at zero, so each
residual branch is exactly zero at init. The pool after the stems is 3x3,
stride 2, padded with -inf.

Dropout runs only when the caller passes a ``generator`` (the train step
does; inference, eval and attribution do not), as the JAX module's runs
only when a 'dropout' rng is supplied: scale 1/keep on kept features. It
does not follow ``module.training``.

Modules carry FAIR pyslowfast's state_dict names (``s1.pathway{0,1}_stem.
{conv,bn}``, ``s{j}_fuse.{conv_f2s,bn}``, ``s{j}.pathway{p}_res{b}.
{branch1,branch1_bn,branch2.{a,b,c}{,_bn}}``, ``s{j}.pathway0_nonlocal{b}.
{conv_theta,conv_phi,conv_g,conv_out,bn}``, ``head.projection``; pathway0
is slow, pathway1 fast) and torch's OITHW conv layout, so a FAIR
checkpoint is its own state_dict less the BN running statistics; the
activations are channels-last (NTHWC).

Contracts: ``SlowFast`` is the 'slowfast' family, ``forward([slow, fast])
-> logits [B, num_classes]`` (engine.slowfast_pathways splits the clip);
``SlowOnly`` the 'torchvision' family, ``forward(x [B,C,T,H,W])``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pathtracker_torch import resolve_device
from pathtracker_torch.models.common import fill_
from pathtracker_torch.ops import initializers as init
from pathtracker_torch.ops.layers import batch_norm, conv3d

BN_EPS = 1e-5  # FAIR's BN epsilon (torch BatchNorm3d's default)
_SLOW_TEMPORAL = (1, 1, 3, 3)  # temporal convs only in res4/res5 (slow path)


class _Conv(nn.Module):
    """A bias-free conv3d on NTHWC with an OITHW ``weight``, kaiming-normal
    (fan_out, relu) init, symmetric k//2 padding."""

    def __init__(self, cin, cout, kernel, gen, stride=(1, 1, 1)):
        super().__init__()
        self.stride = tuple(stride)
        self.padding = tuple(k // 2 for k in kernel)
        std = math.sqrt(2.0 / (cout * math.prod(kernel)))
        self.weight = nn.Parameter(std * torch.randn((cout, cin, *kernel), generator=gen))

    def forward(self, x):
        return conv3d(x, self.weight, stride=self.stride, padding=self.padding)


class _BN(nn.Module):
    """Batch-statistics BN over NTHWC's N, T, H, W; ``zero`` starts the
    scale at 0 (ZERO_INIT_FINAL_BN)."""

    def __init__(self, c, zero: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c) if zero else torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return batch_norm(x, self.weight, self.bias, eps=BN_EPS)


class _Stem(nn.Module):
    """(t,7,7) conv, stride (1,2,2), BN, ReLU."""

    def __init__(self, cin, cout, temporal, gen):
        super().__init__()
        self.conv = _Conv(cin, cout, (temporal, 7, 7), gen, stride=(1, 2, 2))
        self.bn = _BN(cout)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class _Fuse(nn.Module):
    """Lateral fast->slow connection: (k,1,1) conv with temporal stride
    alpha, BN, ReLU, concatenated onto the slow pathway's channels."""

    def __init__(self, cin, ratio, kernel, alpha, gen):
        super().__init__()
        self.conv_f2s = _Conv(cin, cin * ratio, (kernel, 1, 1), gen, stride=(alpha, 1, 1))
        self.bn = _BN(cin * ratio)

    def forward(self, slow, fast):
        return torch.cat([slow, torch.relu(self.bn(self.conv_f2s(fast)))], dim=-1)


class _Branch2(nn.Module):
    def __init__(self, cin, inner, temporal, stride, zero_final_bn, gen):
        super().__init__()
        self.a = _Conv(cin, inner, (temporal, 1, 1), gen)
        self.a_bn = _BN(inner)
        self.b = _Conv(inner, inner, (1, 3, 3), gen, stride=(1, stride, stride))
        self.b_bn = _BN(inner)
        self.c = _Conv(inner, inner * 4, (1, 1, 1), gen)
        self.c_bn = _BN(inner * 4, zero=zero_final_bn)

    def forward(self, x):
        y = torch.relu(self.a_bn(self.a(x)))
        y = torch.relu(self.b_bn(self.b(y)))
        return self.c_bn(self.c(y))


class _Bottleneck(nn.Module):
    """(t,1,1) -> (1,3,3) with the stride -> (1,1,1) to 4x the width, plus
    a strided 1x1x1 projection where the shape changes."""

    def __init__(self, cin, inner, temporal, stride, zero_final_bn, gen):
        super().__init__()
        cout = inner * 4
        self.branch2 = _Branch2(cin, inner, temporal, stride, zero_final_bn, gen)
        if cin != cout or stride != 1:
            self.branch1 = _Conv(cin, cout, (1, 1, 1), gen, stride=(1, stride, stride))
            self.branch1_bn = _BN(cout)

    def forward(self, x):
        res = self.branch1_bn(self.branch1(x)) if hasattr(self, "branch1") else x
        return torch.relu(self.branch2(x) + res)


class _NonLocal(nn.Module):
    """Dot-product non-local block (arXiv:1711.07971): bias-free 1x1x1
    theta/phi/g at half width, softmax over every position of the clip,
    a 1x1x1 conv back with a zero-init BN, added to the input."""

    def __init__(self, c, gen):
        super().__init__()
        half = self.half = max(c // 2, 1)
        self.conv_theta = _Conv(c, half, (1, 1, 1), gen)
        self.conv_phi = _Conv(c, half, (1, 1, 1), gen)
        self.conv_g = _Conv(c, half, (1, 1, 1), gen)
        self.conv_out = _Conv(half, c, (1, 1, 1), gen)
        self.bn = _BN(c, zero=True)

    def forward(self, x):
        b, half = x.shape[0], self.half
        theta = self.conv_theta(x).reshape(b, -1, half)
        phi = self.conv_phi(x).reshape(b, -1, half)
        g = self.conv_g(x).reshape(b, -1, half)
        attn = torch.einsum("bnc,bmc->bnm", theta, phi) / math.sqrt(float(half))
        out = torch.einsum("bnm,bmc->bnc", attn.softmax(dim=-1), g)
        out = out.reshape(*x.shape[:4], half)
        return x + self.bn(self.conv_out(out))


def _pool(x):
    """3x3 spatial max pool, stride 2, -inf padding (1 each side)."""
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), (1, 3, 3), stride=(1, 2, 2),
                     padding=(0, 1, 1))
    return y.permute(0, 2, 3, 4, 1)


def _dropout(feat, rate: float, generator):
    """Inverted dropout when the caller supplies a generator; identity
    otherwise."""
    if rate <= 0 or generator is None:
        return feat
    keep = 1.0 - rate
    mask = torch.rand(feat.shape, generator=generator, device=feat.device) < keep
    return torch.where(mask, feat / keep, torch.zeros_like(feat))


class _Head(nn.Module):
    def __init__(self, cin, num_classes, gen):
        super().__init__()
        self.projection = nn.utils.skip_init(nn.Linear, cin, num_classes)
        fill_(self.projection.weight, init.normal(0.01), gen)
        fill_(self.projection.bias, init.constant(0.0), gen)

    def forward(self, feat):
        return F.linear(feat, self.projection.weight.to(feat.dtype),
                        self.projection.bias.to(feat.dtype))


def _stage(nblocks: int, pathways: Sequence[tuple], nonlocal_blocks, stride: int,
           zero_final_bn: bool, gen) -> tuple[nn.Module, list]:
    """A FAIR stage ``s{j}``: for each pathway (index, cin, inner, temporal
    kernel) its bottlenecks ``pathway{p}_res{b}``, and the slow pathway's
    ``pathway0_nonlocal{b}``. Returns the stage and each pathway's width
    after it."""
    stage = nn.Module()
    widths = []
    for p, cin, inner, temporal in pathways:
        for bi in range(nblocks):
            setattr(stage, f"pathway{p}_res{bi}",
                    _Bottleneck(cin, inner, temporal, stride if bi == 0 else 1,
                                zero_final_bn, gen))
            cin = inner * 4
            if p == 0 and bi in nonlocal_blocks:
                setattr(stage, f"pathway0_nonlocal{bi}", _NonLocal(cin, gen))
        widths.append(cin)
    return stage, widths


def _run_stage(stage: nn.Module, x, p: int, nblocks: int):
    for bi in range(nblocks):
        x = getattr(stage, f"pathway{p}_res{bi}")(x)
        nl = getattr(stage, f"pathway{p}_nonlocal{bi}", None)
        if nl is not None:
            x = nl(x)
    return x


class SlowFast(nn.Module):
    def __init__(self, alpha: int = 4, beta_inv: int = 8, fusion_ratio: int = 2,
                 fusion_kernel: int = 7, width: int = 64,
                 stage_blocks: Sequence[int] = (3, 4, 6, 3),
                 stage_strides: Sequence[int] = (1, 2, 2, 2), num_classes: int = 1,
                 dropout_rate: float = 0.5,
                 nonlocal_slow: Sequence[Sequence[int]] = ((), (), (), ()),
                 zero_init_final_bn: bool = True, in_channels: int = 3,
                 seed: int = 0, device=None):
        super().__init__()
        self.alpha, self.dropout_rate = alpha, dropout_rate
        self.stage_blocks = tuple(stage_blocks)
        gen = torch.Generator().manual_seed(seed)
        w, fw = width, width // beta_inv
        self.s1 = nn.Module()
        self.s1.pathway0_stem = _Stem(in_channels, w, 1, gen)
        self.s1.pathway1_stem = _Stem(in_channels, fw, 5, gen)
        self.s1_fuse = _Fuse(fw, fusion_ratio, fusion_kernel, alpha, gen)
        slow_c, fast_c = w + fw * fusion_ratio, fw
        inners = [w, w * 2, w * 4, w * 8]
        for si, nblocks in enumerate(self.stage_blocks):
            stage, (slow_c, fast_c) = _stage(
                nblocks, [(0, slow_c, inners[si], _SLOW_TEMPORAL[si]),
                              (1, fast_c, inners[si] // beta_inv, 3)],
                nonlocal_slow[si], stage_strides[si], zero_init_final_bn, gen)
            setattr(self, f"s{si + 2}", stage)
            if si < len(self.stage_blocks) - 1:
                setattr(self, f"s{si + 2}_fuse",
                        _Fuse(fast_c, fusion_ratio, fusion_kernel, alpha, gen))
                slow_c += fast_c * fusion_ratio
        self.head = _Head(slow_c + fast_c, num_classes, gen)
        self.to(resolve_device(device))

    def forward(self, pathways, testmode: bool = False, generator=None):
        slow, fast = (p.permute(0, 2, 3, 4, 1) for p in pathways)  # BCTHW -> BTHWC
        slow = _pool(self.s1.pathway0_stem(slow))
        fast = _pool(self.s1.pathway1_stem(fast))
        slow = self.s1_fuse(slow, fast)
        for si, nblocks in enumerate(self.stage_blocks):
            stage = getattr(self, f"s{si + 2}")
            slow = _run_stage(stage, slow, 0, nblocks)
            fast = _run_stage(stage, fast, 1, nblocks)
            if si < len(self.stage_blocks) - 1:
                slow = getattr(self, f"s{si + 2}_fuse")(slow, fast)
        feat = torch.cat([slow.mean(dim=(1, 2, 3)), fast.mean(dim=(1, 2, 3))], dim=-1)
        return self.head(_dropout(feat, self.dropout_rate, generator))


class SlowOnly(nn.Module):
    """The slow pathway alone (reference models/cfgs/slow.yaml, MODEL.ARCH
    slow): the (1,7,7) stem, R50 bottleneck stages with temporal kernels
    only in res4/res5, optional non-local blocks, global pool, dropout and
    a linear head. Torchvision family: a plain BCTHW clip in."""

    def __init__(self, width: int = 64, stage_blocks: Sequence[int] = (3, 4, 6, 3),
                 stage_strides: Sequence[int] = (1, 2, 2, 2), num_classes: int = 1,
                 dropout_rate: float = 0.5,
                 nonlocal_slow: Sequence[Sequence[int]] = ((), (), (), ()),
                 zero_init_final_bn: bool = True, in_channels: int = 3,
                 seed: int = 0, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.stage_blocks = tuple(stage_blocks)
        gen = torch.Generator().manual_seed(seed)
        self.s1 = nn.Module()
        self.s1.pathway0_stem = _Stem(in_channels, width, 1, gen)
        c = width
        for si, nblocks in enumerate(self.stage_blocks):
            stage, (c,) = _stage(nblocks, [(0, c, width * 2 ** si, _SLOW_TEMPORAL[si])],
                                 nonlocal_slow[si], stage_strides[si],
                                 zero_init_final_bn, gen)
            setattr(self, f"s{si + 2}", stage)
        self.head = _Head(c, num_classes, gen)
        self.to(resolve_device(device))

    def forward(self, x, testmode: bool = False, generator=None):
        x = _pool(self.s1.pathway0_stem(x.permute(0, 2, 3, 4, 1)))
        for si, nblocks in enumerate(self.stage_blocks):
            x = _run_stage(getattr(self, f"s{si + 2}"), x, 0, nblocks)
        return self.head(_dropout(x.mean(dim=(1, 2, 3)), self.dropout_rate, generator))


def build(name: str, cfg_path: str | None = None, **kwargs):
    """A SlowFast variant from its yaml (``cfg_path``, by default the port's
    cfgs/<name>.yaml) through slowfast_cfg.load_slowfast_cfg; keyword
    arguments override the yaml's values, the reference's merge direction
    (slowfast_utils.py:13-17)."""
    from pathtracker_torch.models.slowfast_cfg import DEFAULT_CFGS, load_slowfast_cfg

    if name not in DEFAULT_CFGS:
        raise NotImplementedError(name)
    cfg_kwargs = load_slowfast_cfg(cfg_path or DEFAULT_CFGS[name])
    cfg_kwargs.update(kwargs)
    arch = cfg_kwargs.pop("arch", "slowfast")
    # engine.model_step picks the input contract from the model NAME (one
    # BCTHW clip for `slow`, a [slow, fast] pair for `slowfast*`), so a cfg
    # whose MODEL.ARCH contradicts the name would unpack the wrong axis.
    if (name == "slow") != (arch == "slow"):
        raise ValueError(
            f"--model {name} with a cfg whose MODEL.ARCH is '{arch}' "
            f"({cfg_path or DEFAULT_CFGS[name]}): the name picks the input "
            f"contract, the cfg must agree (slow <-> slow)")
    return SlowOnly(**cfg_kwargs) if arch == "slow" else SlowFast(**cfg_kwargs)
