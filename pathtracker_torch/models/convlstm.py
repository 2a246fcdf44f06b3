"""ConvLSTM with a trainable Gabor stem, RBP and the Jacobian penalty
(pathtracker_tpu/models/convlstm.py; reference models/convlstm.py).

The reference iterates the cell ``timesteps`` times on ONE static image (a
[B,1,H,W] image through the Gabor conv0 and x^2, reference
convlstm.py:104-119): a fixed-point recurrent network, not a video model.
Cell (reference :84-90): four gates, each Wx*(x) (with bias) + Wh*(h) (no
bias), no peepholes.

grad_method:
  'bptt' differentiates through the whole unroll, and adds the Jacobian
         penalty relu(J^T 1 - 0.9)^2 on h and on c of the last step
         (reference :154-163; computed on every forward, as there);
  'rbp'  unrolls T-1 steps without gradient and takes the last one through
         ``ops/rbp.py::neumann_rbp`` with ``num_iter`` terms at most
         (reference :124-135).

Contract (the reference's legacy direct call, not the clip pipeline):
``forward(x [B,1,H,W], target=None, criterion=None, testmode=False)``
  -> (output [B,2,H,W], jv_penalty)       with criterion=None;
  -> (output, jv_penalty, loss)           with a criterion;
  testmode returns the list of per-step h maps in jv_penalty's place.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from pathtracker_torch import resolve_device
from pathtracker_torch.models.common import fill_
from pathtracker_torch.ops import initializers as init
from pathtracker_torch.ops.gabor import gabor_bank
from pathtracker_torch.ops.int_fused import BN_EPS
from pathtracker_torch.ops.layers import batch_norm, conv2d, dense
from pathtracker_torch.ops.penalty import jacobian_penalty
from pathtracker_torch.ops.rbp import neumann_rbp

_GATES = ("i", "f", "c", "o")


def _lstm_step(aux, state):
    """One ConvLSTM step (convlstm.py:37-48): ``aux`` the four recurrent
    kernels and the four precomputed input-side gate maps, ``state`` (h, c)."""
    whi, whf, whc, who, xi, xf, xg, xo = aux
    h, cstate = state
    i_t = torch.sigmoid(xi + conv2d(h, whi))
    f_t = torch.sigmoid(xf + conv2d(h, whf))
    c_t = f_t * cstate + i_t * torch.tanh(xg + conv2d(h, whc))
    o_t = torch.sigmoid(xo + conv2d(h, who))
    return o_t * torch.tanh(c_t), c_t


class ConvLSTM(nn.Module):
    def __init__(self, timesteps: int = 8, filt_size: int = 15,
                 num_iter: int = 50, exp_name: str = "exp1",
                 jacobian_penalty: bool = False, grad_method: str = "bptt",
                 hidden: int = 25, in_channels: int = 1, seed: int = 0,
                 device=None):
        super().__init__()
        c, k = hidden, filt_size
        self.timesteps, self.num_iter, self.grad_method = timesteps, num_iter, grad_method
        gen = torch.Generator().manual_seed(seed)
        # The stem starts at the exact Serre bank and trains (reference
        # convlstm.py:104-106 never froze it).
        self.conv0 = nn.utils.skip_init(nn.Conv2d, in_channels, c, 7)
        bank = gabor_bank(n_filters=c, size=7, in_channels=in_channels)  # HWIO
        with torch.no_grad():
            self.conv0.weight.copy_(torch.from_numpy(np.ascontiguousarray(
                bank.transpose(3, 2, 0, 1))))
        fill_(self.conv0.bias, init.torch_conv_bias(in_channels * 49), gen)
        self.unit1 = nn.Module()
        for g in _GATES:
            wx = nn.utils.skip_init(nn.Conv2d, c, c, k)
            fill_(wx.weight, init.torch_conv_default, gen)
            fill_(wx.bias, init.torch_conv_bias(c * k * k), gen)
            wh = nn.utils.skip_init(nn.Conv2d, c, c, k, bias=False)
            fill_(wh.weight, init.torch_conv_default, gen)
            setattr(self.unit1, f"Wx{g}", wx)
            setattr(self.unit1, f"Wh{g}", wh)
        self.bn = nn.BatchNorm2d(c, eps=BN_EPS, track_running_stats=False)
        self.conv6 = nn.utils.skip_init(nn.Conv2d, c, 2, 1)
        std = math.sqrt(2.0 / (c + 2))  # xavier normal, fan_in c, fan_out 2
        fill_(self.conv6.weight, lambda g, s: torch.randn(s, generator=g) * std, gen)
        fill_(self.conv6.bias, init.constant(math.log((1 - 0.01) / 0.01)), gen)
        self.to(resolve_device(device))

    def forward(self, x, target=None, criterion=None, testmode: bool = False):
        cell = self.unit1
        xc = x.permute(0, 2, 3, 1)  # NCHW -> NHWC
        feat = conv2d(xc, self.conv0.weight, self.conv0.bias).square()
        xs = tuple(conv2d(feat, getattr(cell, f"Wx{g}").weight, getattr(cell, f"Wx{g}").bias)
                   for g in _GATES)
        aux = tuple(getattr(cell, f"Wh{g}").weight for g in _GATES) + xs

        h = cstate = torch.zeros_like(feat)
        states, jv = [], torch.ones((1,), device=x.device)
        if "rbp" in self.grad_method:
            with torch.no_grad():
                for _ in range(self.timesteps - 1):
                    h, cstate = _lstm_step(aux, (h, cstate))
                    states.append(h)
            h, cstate = neumann_rbp(_lstm_step, aux, (h, cstate), self.num_iter)
            states.append(h)
        else:
            for _ in range(self.timesteps - 1):
                h, cstate = _lstm_step(aux, (h, cstate))
                states.append(h)
            prev = (h, cstate)
            h, cstate = _lstm_step(aux, prev)
            states.append(h)
            jv_h = jacobian_penalty(lambda hh: _lstm_step(aux, (hh, prev[1]))[0], prev[0])
            jv_c = jacobian_penalty(lambda cc: _lstm_step(aux, (prev[0], cc))[1], prev[1])
            jv = (jv_h + jv_c).reshape(1)

        out = batch_norm(h, self.bn.weight, self.bn.bias)
        out = dense(out, self.conv6.weight[:, :, 0, 0].t(), self.conv6.bias)
        out = out.permute(0, 3, 1, 2)  # NCHW out, like torch
        if criterion is not None:
            loss = criterion(out, target)
            return (out, states, loss) if testmode else (out, jv, loss)
        return (out, states, jv) if testmode else (out, jv)
