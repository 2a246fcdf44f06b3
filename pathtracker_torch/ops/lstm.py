"""Multi-layer (bi)directional LSTM with torch ``nn.LSTM`` semantics
(pathtracker_tpu/ops/lstm.py): gate order i, f, g, o; per layer and
direction ``weight_ih``, ``weight_hh``, ``bias_ih`` and ``bias_hh``, each
drawn from U(-1/sqrt(H), 1/sqrt(H)). Used by the FFLSTM and LRCN baselines.

The JAX package scans the h-recurrence with ``lax.scan``; here the stack IS
an ``nn.LSTM``, so the card runs it through cuDNN's RNN kernels and the CPU
through PyTorch's own. Layout: seq [T, B, D] (seq-first); ``h_n`` and
``c_n`` are [layers * dirs, B, H], the reverse direction of a layer after
its forward one.

Weights map onto the JAX params by a transpose: JAX ``<name>_l<k>_w_ih``
[d_in, 4H] is ``weight_ih_l<k>`` [4H, d_in], ``<name>_l<k>_rev_*`` the
``*_reverse`` tensors (train/torch_import.py); both biases stay apart, as
JAX keeps them (it adds them before the scan, ops/lstm.py:46).
"""

from __future__ import annotations

import math
import warnings

import torch
from torch import nn

# The longest sequence cuDNN's RNN takes: from 65,536 steps on it returns
# CUDNN_STATUS_NOT_SUPPORTED (an H100, any batch, training and inference).
# fflstm at T=64 feeds 64 * 32 * 32 = 65,536 tokens.
CUDNN_MAX_STEPS = 65535


def lstm_params(gen: torch.Generator, input_dim: int, hidden: int, num_layers: int,
                bidirectional: bool) -> nn.LSTM:
    """An ``nn.LSTM`` (seq-first) with every tensor drawn from ``gen``, in the
    JAX package's order: by layer, direction, then w_ih, w_hh, b_ih, b_hh."""
    lstm = nn.LSTM(input_dim, hidden, num_layers, bidirectional=bidirectional,
                   device="meta").to_empty(device="cpu")
    bound = 1.0 / math.sqrt(hidden)
    with torch.no_grad():
        for layer in range(num_layers):
            for sfx in ("", "_reverse")[:2 if bidirectional else 1]:
                for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                    getattr(lstm, f"{kind}_l{layer}{sfx}").uniform_(-bound, bound,
                                                                   generator=gen)
    return lstm


def lstm_apply(lstm: nn.LSTM, seq, state=None):
    """Run the stack over seq [T, B, D] from ``state`` ((h0, c0), zeros when
    None). Returns (out [T, B, H * dirs], (h_n, c_n)). A sequence longer
    than cuDNN takes runs one layer and direction at a time in pieces."""
    if seq.shape[0] > CUDNN_MAX_STEPS:
        return _by_direction(lstm, seq, state, CUDNN_MAX_STEPS)
    return lstm(seq.contiguous(), state)


def _by_direction(lstm: nn.LSTM, seq, state, chunk: int):
    """The stack one layer and direction at a time, each direction over
    pieces of at most ``chunk`` steps with its (h, c) carried from piece to
    piece (the reverse one over the flipped sequence): the same recurrence
    as ``lstm(seq, state)``."""
    dirs = 2 if lstm.bidirectional else 1
    if state is None:
        zeros = seq.new_zeros((lstm.num_layers * dirs, seq.shape[1], lstm.hidden_size))
        state = (zeros, zeros)
    h_n, c_n, out = [], [], seq
    for layer in range(lstm.num_layers):
        outs = []
        for d in range(dirs):
            sfx = f"_l{layer}" + ("_reverse" if d else "")
            weights = [getattr(lstm, kind + sfx)
                       for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
            i = layer * dirs + d
            h, c = state[0][i:i + 1], state[1][i:i + 1]
            pieces = []
            for piece in (out.flip(0) if d else out).split(chunk):
                with warnings.catch_warnings():
                    # one direction's tensors are not one flat cuDNN buffer:
                    # cuDNN copies them (a few hundred floats) each call
                    warnings.filterwarnings("ignore", "RNN module weights are not part")
                    y, h, c = torch._VF.lstm(piece.contiguous(), (h, c), weights, True, 1,
                                             0.0, lstm.training, False, False)
                pieces.append(y)
            y = torch.cat(pieces)
            outs.append(y.flip(0) if d else y)
            h_n.append(h)
            c_n.append(c)
        out = torch.cat(outs, dim=-1)
    return out, (torch.cat(h_n), torch.cat(c_n))
