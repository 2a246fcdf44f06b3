"""LSTM-over-pixels baseline (pathtracker_tpu/models/fflstm.py; reference
models/fflstm.py).

A frozen gaussian-init Conv3d (3->E, k=7, no bias) + x^2; the video
flattened into per-sample sequences of T*H*W tokens of E features, fed
through a 2-layer bidirectional LSTM (ops/lstm.py, cuDNN on the card)
``timesteps`` times with the states carried; InstanceNorm (per sample and
channel over T, H, W, no affine, eps 1e-3) over the outputs reshaped back
to a video; AvgPool3d(2); one Linear to the logit.

The stem is a parameter, as in the JAX module (so checkpoints and Adam's
state tree match), but enters the forward detached (``stop_gradient``
there): its gradient is None, which the train step turns into a zero, and
Adam leaves it unchanged.

``timesteps`` is both the number of passes and the clip length (the
registry passes the clip length), which with ``height`` and ``width`` fixes
the Linear's width.

Contract: ``forward(x [B,3,T,H,W]) -> (logit [B,1], ones(1))``; with a
``criterion``, the legacy ``(prob [B], ones(1), loss)``.
"""

from __future__ import annotations

import torch
from torch import nn

from pathtracker_torch import resolve_device
from pathtracker_torch.models.common import fill_
from pathtracker_torch.ops import initializers as init
from pathtracker_torch.ops.layers import avg_pool3d, conv3d, dense
from pathtracker_torch.ops.lstm import lstm_apply, lstm_params


class FFLSTM(nn.Module):
    def __init__(self, timesteps: int = 8, filt_size: int = 15, num_iter: int = 50,
                 exp_name: str = "exp1", jacobian_penalty: bool = False,
                 grad_method: str = "bptt", hgru_size: int = 4, embedding_dim: int = 3,
                 height: int = 32, width: int = 32, seed: int = 0, device=None):
        super().__init__()
        e, hh = embedding_dim, hgru_size
        self.timesteps, self.hgru_size = timesteps, hgru_size
        gen = torch.Generator().manual_seed(seed)
        self.conv00 = nn.utils.skip_init(nn.Conv3d, 3, e, 7, bias=False)
        fill_(self.conv00.weight, init.normal(1.0), gen)
        self.unit1 = lstm_params(gen, e, hh, num_layers=2, bidirectional=True)
        feat = 2 * hh * (timesteps // 2) * (height // 2) * (width // 2)
        self.fc4 = nn.utils.skip_init(nn.Linear, feat, 1)
        fill_(self.fc4.weight, init.torch_conv_default, gen)
        fill_(self.fc4.bias, init.torch_conv_bias(feat), gen)
        self.to(resolve_device(device))

    def forward(self, x, target=None, criterion=None, testmode: bool = False):
        out = conv3d(x.permute(0, 2, 3, 4, 1), self.conv00.weight.detach()).square()
        b, t, h, w, e = out.shape
        seq = out.reshape(b, t * h * w, e).transpose(0, 1)  # [T*H*W, B, E]
        state = None
        for _ in range(self.timesteps):
            output, state = lstm_apply(self.unit1, seq, state)

        vid = output.transpose(0, 1).reshape(b, t, h, w, 2 * self.hgru_size)
        mean = vid.mean(dim=(1, 2, 3), keepdim=True)
        var = (vid - mean).square().mean(dim=(1, 2, 3), keepdim=True)
        vid = (vid - mean) * torch.rsqrt(var + 1e-3)
        flat = avg_pool3d(vid, 2).reshape(b, -1)
        logit = dense(flat, self.fc4.weight.t(), self.fc4.bias)
        ones = torch.ones((1,), dtype=logit.dtype, device=logit.device)
        if criterion is not None:
            prob = torch.sigmoid(logit.reshape(-1))
            return prob, ones, criterion(prob, target)
        return logit, ones
