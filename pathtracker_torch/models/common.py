"""Shared model pieces: the target-conditioned readout
(pathtracker_tpu/models/common.py).

Collapse the final state to 1 channel with a 1x1 conv, concatenate the blue
channel of frame 0 (the target-dot marker), 5x5 'SAME' conv to 1 channel,
global average pool, then a Linear(1, 1) to a single logit; all f32. The
three modules live on the host model under the reference's state_dict names
(``readout_conv``, ``target_conv``, ``readout_dense``), and the 1x1 conv
also runs per step for testmode's state maps.
"""

from __future__ import annotations

import torch
from torch import nn

from pathtracker_torch.ops import initializers as init
from pathtracker_torch.ops.layers import conv2d, dense, global_avg_pool


def fill_(param: torch.Tensor, initializer, gen: torch.Generator) -> None:
    """Overwrite ``param`` in place with ``initializer(gen, shape)``."""
    with torch.no_grad():
        param.copy_(initializer(gen, tuple(param.shape)))


def make_readout(mod: nn.Module, dimensions: int, gen: torch.Generator) -> None:
    """Register the readout modules on ``mod`` (torch default inits;
    target_conv bias zero-init per reference models/InT.py:206)."""
    mod.readout_conv = nn.utils.skip_init(nn.Conv2d, dimensions, 1, 1)
    mod.target_conv = nn.utils.skip_init(nn.Conv2d, 2, 1, 5, padding=2)
    mod.readout_dense = nn.utils.skip_init(nn.Linear, 1, 1)
    fill_(mod.readout_conv.weight, init.torch_conv_default, gen)
    fill_(mod.readout_conv.bias, init.torch_conv_bias(dimensions), gen)
    fill_(mod.target_conv.weight, init.torch_conv_default, gen)
    fill_(mod.target_conv.bias, init.constant(0.0), gen)
    fill_(mod.readout_dense.weight, init.torch_conv_default, gen)
    fill_(mod.readout_dense.bias, init.torch_conv_bias(1), gen)


def readout_state_map(mod: nn.Module, state_hwc):
    """1x1 readout conv: [B,H,W,C] -> [B,H,W,1]."""
    conv = mod.readout_conv
    return dense(state_hwc, conv.weight[:, :, 0, 0].t(), conv.bias)


def target_readout(mod: nn.Module, state_hwc, target_hw):
    """Full readout: ([B,H,W,C] state, [B,H,W] frame-0 blue) -> [B,1] logit."""
    merged = torch.cat([readout_state_map(mod, state_hwc), target_hw[..., None]],
                       dim=-1)
    out = conv2d(merged, mod.target_conv.weight, mod.target_conv.bias)
    out = global_avg_pool(out)
    return dense(out, mod.readout_dense.weight.t(), mod.readout_dense.bias)
