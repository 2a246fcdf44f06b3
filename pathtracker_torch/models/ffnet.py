"""Feedforward 3-D conv baseline (pathtracker_tpu/models/ffnet.py;
reference models/FFnet.py).

conv0 (3->C, k=7, no bias) + BN, then six k x k x k conv + BN + ReLU blocks
at C channels, a 1x1x1 conv to 2 channels, flatten in (C, T, H, W) order
as torch's view does, and a Linear to 2 class logits. Every BN uses batch
statistics with eps 1e-5 (torch BatchNorm3d's default, which the reference
keeps). The 1x1x1 conv is held as a Linear [2, C].

``timesteps`` (the clip length; the JAX module reads it from the input),
``height`` and ``frame_width`` fix the Linear's width; ``width`` is the
channel width, as in the JAX module.

Contracts:
  forward(x) -> (logit [B,1], ones(1)), logit = out[:,1] - out[:,0], the
      binary log-odds of the 2-class softmax the reference trained;
  forward(x, target, criterion) -> (out [B,2], ones(1), criterion(out, target)).
"""

from __future__ import annotations

import torch
from torch import nn

from pathtracker_torch import resolve_device
from pathtracker_torch.models.common import fill_
from pathtracker_torch.ops import initializers as init
from pathtracker_torch.ops.layers import batch_norm, conv3d, dense

BN_EPS = 1e-5


class FFConvNet(nn.Module):
    def __init__(self, filt_size: int = 15, num_iter: int = 50, exp_name: str = "exp1",
                 jacobian_penalty: bool = False, grad_method: str = "bptt",
                 width: int = 25, timesteps: int = 64, height: int = 32,
                 frame_width: int = 32, seed: int = 0, device=None):
        super().__init__()
        c, k = width, filt_size
        gen = torch.Generator().manual_seed(seed)
        self.conv0 = nn.utils.skip_init(nn.Conv3d, 3, c, 7, bias=False)
        fill_(self.conv0.weight, init.torch_conv_default, gen)
        for i in range(7):
            setattr(self, f"bn{i}", nn.BatchNorm3d(c, eps=BN_EPS, track_running_stats=False))
            if i:
                conv = nn.utils.skip_init(nn.Conv3d, c, c, k)
                fill_(conv.weight, init.torch_conv_default, gen)
                fill_(conv.bias, init.torch_conv_bias(c * k ** 3), gen)
                setattr(self, f"conv{i}", conv)
        self.conv7 = nn.utils.skip_init(nn.Linear, c, 2)
        fill_(self.conv7.weight, init.torch_conv_default, gen)
        fill_(self.conv7.bias, init.torch_conv_bias(c), gen)
        feat = 2 * timesteps * height * frame_width
        self.fc4 = nn.utils.skip_init(nn.Linear, feat, 2)
        fill_(self.fc4.weight, init.torch_conv_default, gen)
        fill_(self.fc4.bias, init.torch_conv_bias(feat), gen)
        self.to(resolve_device(device))

    def _features(self, x):
        out = conv3d(x.permute(0, 2, 3, 4, 1), self.conv0.weight)
        out = batch_norm(out, self.bn0.weight, self.bn0.bias, BN_EPS)
        for i in range(1, 7):
            conv, bn = getattr(self, f"conv{i}"), getattr(self, f"bn{i}")
            out = conv3d(out, conv.weight, conv.bias)
            out = torch.relu(batch_norm(out, bn.weight, bn.bias, BN_EPS))
        out = dense(out, self.conv7.weight.t(), self.conv7.bias)  # [B,T,H,W,2]
        flat = out.permute(0, 4, 1, 2, 3).reshape(out.shape[0], -1)  # CTHW order
        return dense(flat, self.fc4.weight.t(), self.fc4.bias)

    def forward(self, x, target=None, criterion=None, testmode: bool = False):
        out = self._features(x)
        ones = torch.ones((1,), dtype=out.dtype, device=out.device)
        if criterion is not None:
            return out, ones, criterion(out, target)
        return (out[:, 1] - out[:, 0])[:, None], ones
