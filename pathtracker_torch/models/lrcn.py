"""LRCN-style baselines (pathtracker_tpu/models/lrcn.py; reference
models/lrcn_style.py and lrcn_style_last_readout.py, arXiv:1411.4389
lineage).

Gaussian-init Conv3d(3->3, no bias) + leaky_relu, Conv3d(3->E) +
leaky_relu, AvgPool3d(2); per pooled frame, the frame's tokens run through
LSTM-1 (2 layers, bidirectional, E->H); LSTM-2 (2 layers, bidirectional,
2H->E) reads LSTM-1's outputs from states fused every frame after the
first by a chunked mean over the concatenated states of both LSTMs; a
per-frame Linear gives a logit per frame.

Standard contract: ``forward(x) -> (logit [B,1], ones(1))``, the last
frame's logit. Legacy contract (``criterion``, a callable on (prob [B],
target)): ``LRCNStyle`` majority-votes the per-frame probabilities (> 0.5)
into the pseudo-probabilities 0.7 / 0.2, ``LRCNStyleLast`` returns the
last frame's probability; the loss is the mean of the per-frame criteria.
``deterministic`` is accepted as in the JAX module: no dropout is applied.

``height`` and ``width`` are the clip's; they fix the Linear's width.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pathtracker_torch import resolve_device
from pathtracker_torch.models.common import fill_
from pathtracker_torch.ops import initializers as init
from pathtracker_torch.ops.layers import avg_pool3d, conv3d, dense
from pathtracker_torch.ops.lstm import lstm_apply, lstm_params


def _chunked_mean_fuse(a, b):
    """Fuse [L,B,H1] and [L,B,H2] states: concatenate on the features and
    average chunks of (H1+H2)//H2 down to H2 features (lrcn.py:36-46)."""
    cat = torch.cat([a, b], dim=2)
    h2 = b.shape[2]
    chunk = max(cat.shape[2] // h2, 1)
    return cat[:, :, :h2 * chunk].reshape(cat.shape[0], cat.shape[1], h2, chunk).mean(dim=3)


class _LRCNBase(nn.Module):
    vote = True  # False: the last frame's readout (lrcn_style_last_readout)

    def __init__(self, batch_size: int = 0, timesteps: int = 8, filt_size: int = 15,
                 num_iter: int = 50, exp_name: str = "exp1",
                 jacobian_penalty: bool = False, grad_method: str = "bptt",
                 hidden_size: int = 32, embedding_dim: int = 4, height: int = 32,
                 width: int = 32, seed: int = 0, device=None):
        super().__init__()
        e, hh = embedding_dim, hidden_size
        gen = torch.Generator().manual_seed(seed)
        self.conv0 = nn.utils.skip_init(nn.Conv3d, 3, 3, 7, bias=False)
        fill_(self.conv0.weight, init.normal(1.0), gen)
        self.conv1 = nn.utils.skip_init(nn.Conv3d, 3, e, 7)
        fill_(self.conv1.weight, init.torch_conv_default, gen)
        fill_(self.conv1.bias, init.torch_conv_bias(3 * 343), gen)
        self.lstm1 = lstm_params(gen, e, hh, num_layers=2, bidirectional=True)
        self.lstm2 = lstm_params(gen, 2 * hh, e, num_layers=2, bidirectional=True)
        feat = (height // 2) * (width // 2) * e * 2
        self.fc1 = nn.utils.skip_init(nn.Linear, feat, 1)
        fill_(self.fc1.weight, init.torch_conv_default, gen)
        fill_(self.fc1.bias, init.torch_conv_bias(feat), gen)
        self.to(resolve_device(device))

    def forward(self, x, target=None, criterion=None, testmode: bool = False,
                deterministic: bool = True):
        out = F.leaky_relu(conv3d(x.permute(0, 2, 3, 4, 1), self.conv0.weight))
        out = F.leaky_relu(conv3d(out, self.conv1.weight, self.conv1.bias))
        out = avg_pool3d(out, 2)
        b, t, h, w, e = out.shape

        state1 = state2 = None
        frame_logits = []
        for ti in range(t):
            seq = out[:, ti].reshape(b, h * w, e).transpose(0, 1)  # [HW, B, E]
            out1, state1 = lstm_apply(self.lstm1, seq, state1)
            if state2 is not None:
                state2 = (_chunked_mean_fuse(state1[0], state2[0]),
                          _chunked_mean_fuse(state1[1], state2[1]))
            out2, state2 = lstm_apply(self.lstm2, out1, state2)
            flat = out2.transpose(0, 1).reshape(b, -1)
            frame_logits.append(dense(flat, self.fc1.weight.t(), self.fc1.bias).reshape(-1))
        logits = torch.stack(frame_logits, dim=1)  # [B, T]
        ones = torch.ones((1,), dtype=logits.dtype, device=logits.device)

        if criterion is not None:
            probs = torch.sigmoid(logits)
            loss = torch.stack([criterion(probs[:, i], target) for i in range(t)]).mean()
            if self.vote:
                votes = (probs > 0.5).sum(dim=1) > (t / 2)
                outputs = torch.where(votes, 0.7, 0.2).to(probs.dtype)
            else:
                outputs = probs[:, -1]
            return outputs, ones, loss
        return logits[:, -1:], ones


class LRCNStyle(_LRCNBase):
    vote = True


class LRCNStyleLast(_LRCNBase):
    vote = False
