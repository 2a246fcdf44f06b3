"""ConvGRU baseline, ``--model gru`` (pathtracker_tpu/models/convgru.py;
reference models/kys.py).

A reset/update ConvGRU on concat([input, state]) (reference kys.py:35-48),
wrapped like InT: 1x1x1 preproc + softplus, zero state, one step per frame,
the target-conditioned readout (kys.py:102-135). Each of the three k x k
convs (``unit1.conv_reset``, ``conv_update``, ``conv_state_new``: OIHW
[C, 2C, k, k]) splits into its input half (weight[:, :C]), hoisted over all
frames as one conv, and its state half (weight[:, C:]) in the step. The
registry builds it at twice the InT width (registry.py:110-115).
"""

from __future__ import annotations

import torch
from torch import nn

from pathtracker_torch import resolve_device
from pathtracker_torch.models import common
from pathtracker_torch.models.common import fill_
from pathtracker_torch.models.int_circuit import recomputed
from pathtracker_torch.ops import initializers as init
from pathtracker_torch.ops.layers import conv2d, dense, softplus

_CONVS = ("conv_reset", "conv_update", "conv_state_new")


def _gru_step(p, xt, carry, *, mxu, tape=None):
    """One ConvGRU step (convgru.py:81-87): ``xt`` the hoisted input halves
    (rx, ux, cx), ``carry`` (state,). Returns ((new_state,), reset)."""
    rx, ux, cx = xt
    (state,) = carry

    def fconv(z, kern):
        return conv2d(z, kern, mxu_dtype=mxu)

    reset = torch.sigmoid(rx + fconv(state, p["reset_h"]) + p["reset_b"])
    update = torch.sigmoid(ux + fconv(state, p["update_h"]) + p["update_b"])
    cand = torch.tanh(cx + fconv(reset * state, p["cand_h"]) + p["cand_b"])
    return ((1.0 - update) * state + update * cand,), reset


class GRU(nn.Module):
    def __init__(self, dimensions: int = 64, timesteps: int = 64,
                 kernel_size: int = 15, remat: bool = True,
                 dtype: str = "float32", grad_method: str = "bptt",
                 seed: int = 0, device=None):
        super().__init__()
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', got {dtype!r}")
        c, k = dimensions, kernel_size
        self.dimensions, self.timesteps = c, timesteps
        self.remat, self.grad_method = remat, grad_method
        self.mxu = torch.bfloat16 if dtype == "bfloat16" else None
        gen = torch.Generator().manual_seed(seed)
        self.preproc = nn.utils.skip_init(nn.Conv3d, 3, c, 1)
        fill_(self.preproc.weight, init.torch_conv_default, gen)
        fill_(self.preproc.bias, init.torch_conv_bias(3), gen)
        self.unit1 = nn.Module()
        for name in _CONVS:
            conv = nn.utils.skip_init(nn.Conv2d, 2 * c, c, k)
            fill_(conv.weight, init.torch_conv_default, gen)
            fill_(conv.bias, init.torch_conv_bias(2 * c * k * k), gen)
            setattr(self.unit1, name, conv)
        common.make_readout(self, c, gen)
        self.to(resolve_device(device))

    def forward(self, x, testmode: bool = False):
        c, mxu = self.dimensions, self.mxu
        xc = x.permute(2, 0, 3, 4, 1)  # [T,B,H,W,3]
        t, b, h, w, _ = xc.shape
        xbn = softplus(dense(xc, self.preproc.weight.view(c, 3).t(), self.preproc.bias))
        flat = xbn.reshape(t * b, h, w, c)
        p, hoisted = {}, []
        for short, name in zip(("reset", "update", "cand"), _CONVS):
            conv = getattr(self.unit1, name)
            # Input halves over all frames at once, stored bf16 under the
            # mixed policy (convgru.py:71-79).
            z = conv2d(flat, conv.weight[:, :c], mxu_dtype=mxu).reshape(t, b, h, w, c)
            hoisted.append(z.to(mxu) if mxu is not None else z)
            p[f"{short}_h"], p[f"{short}_b"] = conv.weight[:, c:], conv.bias

        def step(p, xt, carry, tape=None):
            return _gru_step(p, xt, carry, mxu=mxu)

        grad = torch.is_grad_enabled() and (
            x.requires_grad or any(q.requires_grad for q in self.parameters()))
        if grad and self.remat:
            step = recomputed(step, tuple(p), 1)
        carry = (torch.zeros((b, h, w, c), dtype=torch.float32, device=x.device),)
        states, resets = [], []
        for xt in zip(*(z.unbind(0) for z in hoisted)):
            carry, reset = step(p, xt, carry)
            if testmode:
                states.append(common.readout_state_map(self, carry[0]))
                resets.append(reset)
        logit = common.target_readout(self, carry[0], x[:, 2, 0])
        if testmode:
            return (logit, torch.stack(states).permute(1, 0, 4, 2, 3),
                    torch.stack(resets).permute(1, 0, 4, 2, 3))
        return logit, torch.ones((1,), device=x.device)
