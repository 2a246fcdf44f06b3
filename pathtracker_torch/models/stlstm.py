"""PredRNN-style Spatio-Temporal LSTM (pathtracker_tpu/models/stlstm.py;
reference models/SpatioTemporalLSTMCell.py + models/ffstlstm.py).

Cell: conv_x -> 7 gate maps, conv_h -> 4, conv_m -> 3, each a 'SAME' conv
followed by LayerNorm over the sample's [H, W, C]; dual memories, the
temporal c (i, f, g from x and h) and the spatiotemporal m (i', f', g' from
x and m), forget bias 1.0; the output gate reads cat(c, m) through conv_o,
and h = o * tanh(conv_last(cat(c, m))).

Stack: 3x (Conv3d k=7, no bias, + ReLU + MaxPool3d 2) encoder 3->25->10->C,
then per encoded frame FOUR layers sharing ONE cell and one memory m
threaded through layers and time. Readout from the top h: batch-stat BN
(eps 1e-3) -> AvgPool2d(2) -> flatten (H, W, C order, as the JAX model) ->
Linear -> the logit.

Unlike the JAX module, whose LayerNorm and Linear widths follow the first
input, a torch module fixes them at construction: ``height`` and ``width``
are the clip's (after three pools each is /8).

Contract: ``forward(x [B,3,T,H,W]) -> (logit [B,1], ones(1))``; with a
``criterion`` (a callable on (prob [B], target)), the legacy
``(prob [B], ones(1), loss)``.
"""

from __future__ import annotations

import torch
from torch import nn

from pathtracker_torch import resolve_device
from pathtracker_torch.models.common import fill_
from pathtracker_torch.ops import initializers as init
from pathtracker_torch.ops.layers import (avg_pool2d, batch_norm, conv2d, conv3d,
                                          dense, layer_norm_2d, max_pool3d)


def _conv_ln(cin: int, cout: int, k: int, height: int, width: int, gen) -> nn.Sequential:
    """A 'SAME' conv (``0``) and its LayerNorm over [C, H, W] (``1``)."""
    conv = nn.utils.skip_init(nn.Conv2d, cin, cout, k)
    fill_(conv.weight, init.torch_conv_default, gen)
    fill_(conv.bias, init.torch_conv_bias(cin * k * k), gen)
    return nn.Sequential(conv, nn.LayerNorm([cout, height, width]))


class SpatioTemporalLSTMCell(nn.Module):
    def __init__(self, in_channel: int, num_hidden: int, filter_size: int,
                 height: int, width: int, gen: torch.Generator,
                 forget_bias: float = 1.0):
        super().__init__()
        ch, k = num_hidden, filter_size
        self.num_hidden, self.forget_bias = ch, forget_bias
        self.conv_x = _conv_ln(in_channel, 7 * ch, k, height, width, gen)
        self.conv_h = _conv_ln(ch, 4 * ch, k, height, width, gen)
        self.conv_m = _conv_ln(ch, 3 * ch, k, height, width, gen)
        self.conv_o = _conv_ln(2 * ch, ch, k, height, width, gen)
        self.conv_last = nn.utils.skip_init(nn.Linear, 2 * ch, ch)  # a 1x1 conv
        fill_(self.conv_last.weight, init.torch_conv_default, gen)
        fill_(self.conv_last.bias, init.torch_conv_bias(2 * ch), gen)

    @staticmethod
    def _branch(branch: nn.Sequential, src):
        conv, ln = branch
        z = conv2d(src, conv.weight, conv.bias)
        return layer_norm_2d(z, ln.weight.permute(1, 2, 0), ln.bias.permute(1, 2, 0),
                             ln.eps)

    def forward(self, x_t, h_t, c_t, m_t):
        """NHWC x, h, c, m -> (h, c, m)."""
        i_x, f_x, g_x, i_xp, f_xp, g_xp, o_x = self._branch(self.conv_x, x_t).chunk(7, -1)
        i_h, f_h, g_h, o_h = self._branch(self.conv_h, h_t).chunk(4, -1)
        i_m, f_m, g_m = self._branch(self.conv_m, m_t).chunk(3, -1)

        i_t = torch.sigmoid(i_x + i_h)
        f_t = torch.sigmoid(f_x + f_h + self.forget_bias)
        c_new = f_t * c_t + i_t * torch.tanh(g_x + g_h)

        i_tp = torch.sigmoid(i_xp + i_m)
        f_tp = torch.sigmoid(f_xp + f_m + self.forget_bias)
        m_new = f_tp * m_t + i_tp * torch.tanh(g_xp + g_m)

        mem = torch.cat([c_new, m_new], dim=-1)
        o_t = torch.sigmoid(o_x + o_h + self._branch(self.conv_o, mem))
        h_new = o_t * torch.tanh(dense(mem, self.conv_last.weight.t(), self.conv_last.bias))
        return h_new, c_new, m_new


class FFSTLSTM(nn.Module):
    def __init__(self, timesteps: int = 8, filt_size: int = 15, num_iter: int = 50,
                 exp_name: str = "exp1", jacobian_penalty: bool = False,
                 grad_method: str = "bptt", num_layers: int = 4, hidden: int = 8,
                 height: int = 32, width: int = 32, seed: int = 0, device=None):
        super().__init__()
        ch = hidden
        self.timesteps, self.num_layers, self.hidden = timesteps, num_layers, hidden
        gen = torch.Generator().manual_seed(seed)
        for i, (cin, cout) in enumerate([(3, 25), (25, 10), (10, ch)]):
            conv = nn.utils.skip_init(nn.Conv3d, cin, cout, 7, bias=False)
            fill_(conv.weight, init.torch_conv_default, gen)
            setattr(self, f"conv{i}", conv)
        h, w = height // 8, width // 8
        self.unit1 = SpatioTemporalLSTMCell(ch, ch, filt_size, h, w, gen)
        self.bn = nn.BatchNorm2d(ch, eps=1e-3, track_running_stats=False)
        feat = ch * (h // 2) * (w // 2)
        self.fc4 = nn.utils.skip_init(nn.Linear, feat, 1)
        fill_(self.fc4.weight, init.torch_conv_default, gen)
        fill_(self.fc4.bias, init.torch_conv_bias(feat), gen)
        self.to(resolve_device(device))

    def forward(self, x, target=None, criterion=None, testmode: bool = False):
        out = x.permute(0, 2, 3, 4, 1)  # [B,T,H,W,3]
        for conv in (self.conv0, self.conv1, self.conv2):
            out = max_pool3d(torch.relu(conv3d(out, conv.weight)))
        b, t, h, w, _ = out.shape

        zeros = out.new_zeros((b, h, w, self.hidden))
        h_t = [zeros] * self.num_layers
        c_t = [zeros] * self.num_layers
        memory = zeros
        for ti in range(t):
            h_t[0], c_t[0], memory = self.unit1(out[:, ti], h_t[0], c_t[0], memory)
            for i in range(1, self.num_layers):
                h_t[i], c_t[i], memory = self.unit1(h_t[i - 1], h_t[i], c_t[i], memory)

        pooled = avg_pool2d(batch_norm(h_t[-1], self.bn.weight, self.bn.bias, self.bn.eps), 2)
        logit = dense(pooled.reshape(b, -1), self.fc4.weight.t(), self.fc4.bias)
        ones = torch.ones((1,), dtype=logit.dtype, device=logit.device)
        if criterion is not None:
            prob = torch.sigmoid(logit.reshape(-1))
            return prob, ones, criterion(prob, target)
        return logit, ones
