"""hGRU family (pathtracker_tpu/models/hgru.py; reference
models/ffhgru_hierarchy.py: hConvGRUCell :59, FFhGRU :176, FFhGRU_v2 :279).

The cell differs from the InT rCell (reference ffhgru_hierarchy.py:135-173):
  * the attention map also stands in for the inhibition in the gates:
    gated_inhibition = att (not the inhibition state);
  * without attention the cell reads the ungated state (the reference's
    no-attention path never assigned it; the JAX package implements the
    intent);
  * FFhGRU_v2 reads out by concatenating the raw excitation with channels
    1: of frame 0 into a 1x1 conv and a global pool;
  * ClockHGRU adds per-step, per-channel update masks ('fixed': channel
    groups with periods 1, 2, 4, ...; 'dynamic': a learned rate
    sigmoid(clock_rate)) and a dense readout over every frame's 1x1 map.

The cell's parameters are the InT cell's (``RCell``: ``unit1.*`` in the
reference state_dict) with every scalar present. Same structure as the
port's InT eager cell: the input projections hoisted over all frames
(stored bf16 under the mixed policy), batch-stat BN, an f32 carry, and in
training each step recomputed in backward from its inputs
(``_RecomputedStep``, the JAX package's per-step ``jax.checkpoint``).
"""

from __future__ import annotations

import torch
from torch import nn

from pathtracker_torch import resolve_device
from pathtracker_torch.models import common
from pathtracker_torch.models.common import fill_
from pathtracker_torch.models.int_circuit import RCell, recomputed
from pathtracker_torch.ops import initializers as init
from pathtracker_torch.ops.int_fused import BN_EPS
from pathtracker_torch.ops.layers import (batch_norm, conv2d, dense,
                                          global_avg_pool, softplus)


def _hgru_step(p, xt, carry, *, use_attention, mxu, tape=None):
    """One hConvGRU step on [B,H,W,C] tensors (hgru.py:131-158). ``xt`` is
    (inp, att_x, gi_x, mask); ``mask`` [C] or None."""
    inp, att_x, gi_x, mask = xt
    inh, exc = carry

    def fdense(z, kern, bias):
        return dense(z, kern, bias, mxu_dtype=mxu)

    def fconv(z, kern):
        y = conv2d(z, kern, mxu_dtype=mxu, keep_mxu_dtype=True)
        return y.float() if mxu is not None else y

    if use_attention:
        att = torch.sigmoid(att_x + fdense(exc, p["a_u"], p["a_u_b"]))
        gated_exc = att * exc
        gated_inh = att  # hGRU: the gate tensor stands in for inhibition
    else:
        att = torch.ones_like(exc)
        gated_exc, gated_inh = exc, inh
    inh_intx = batch_norm(fconv(gated_exc, p["w_inh"]), p["bn0_scale"], p["bn0_bias"])
    inh_hat = softplus(inp - softplus(inh_intx * (p["alpha"] * gated_inh + p["mu"])))
    g_i = torch.sigmoid(gi_x + fdense(gated_inh, p["i_u"], p["i_u_b"]))
    new_inh = (1.0 - g_i) * inh + g_i * inh_hat
    g_e = torch.sigmoid(fdense(gated_inh, p["e_w"], p["e_w_b"])
                        + fdense(gated_exc, p["e_u"], p["e_u_b"]))
    exc_intx = batch_norm(fconv(new_inh, p["w_exc"]), p["bn1_scale"], p["bn1_bias"])
    exc_hat = softplus(exc_intx * (p["kappa"] * new_inh + p["gamma"]))
    new_exc = (1.0 - g_e) * exc + g_e * exc_hat
    if mask is not None:
        new_inh = mask * new_inh + (1.0 - mask) * inh
        new_exc = mask * new_exc + (1.0 - mask) * exc
    return (new_inh, new_exc), att


class _HGRUBase(nn.Module):
    """The cell's parameters (``unit1``) and the recurrence over frames."""

    use_attention = True

    def __init__(self, dimensions: int = 32, timesteps: int = 64,
                 kernel_size: int = 15, use_attention: bool | None = None,
                 remat: bool = True, dtype: str = "float32",
                 grad_method: str = "bptt", seed: int = 0):
        super().__init__()
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', got {dtype!r}")
        if use_attention is not None:
            self.use_attention = use_attention
        self.dimensions, self.timesteps = dimensions, timesteps
        self.remat, self.grad_method = remat, grad_method
        self.mxu = torch.bfloat16 if dtype == "bfloat16" else None
        self.gen = torch.Generator().manual_seed(seed)
        self.preproc = nn.utils.skip_init(nn.Conv3d, 3, dimensions, 1)
        fill_(self.preproc.weight, init.torch_conv_default, self.gen)
        fill_(self.preproc.bias, init.torch_conv_bias(3), self.gen)
        self.unit1 = RCell(dimensions, kernel_size, timesteps, self.use_attention,
                           False, frozenset(), self.gen)

    def _params(self):
        cell = self.unit1

        def kern(name):
            return getattr(cell, name).weight[:, :, 0, 0].t()

        p = {}
        gates = ("i_w", "i_u", "e_w", "e_u") + (("a_w", "a_u") if self.use_attention else ())
        for g in gates:
            p[g], p[f"{g}_b"] = kern(f"{g}_gate"), getattr(cell, f"{g}_gate").bias
        for name in ("alpha", "mu", "gamma", "kappa"):
            p[name] = getattr(cell, name).view(-1)
        p.update(w_inh=cell.w_inh, w_exc=cell.w_exc,
                 bn0_scale=cell.bn[0].weight, bn0_bias=cell.bn[0].bias,
                 bn1_scale=cell.bn[1].weight, bn1_bias=cell.bn[1].bias)
        return p

    def _run(self, xbn, collect: bool, clock_masks=None):
        """xbn [T,B,H,W,C] -> (inh, exc, excs, atts); ``excs``/``atts`` the
        per-step lists when ``collect``. ``clock_masks`` [T, C] or None."""
        p, mxu = self._params(), self.mxu

        def store(z):
            return z.to(mxu) if mxu is not None else z

        att_in = (store(dense(xbn, p["a_w"], p["a_w_b"], mxu_dtype=mxu))
                  if self.use_attention else None)
        gi_in = store(dense(xbn, p["i_w"], p["i_w_b"], mxu_dtype=mxu))
        inp = store(xbn)
        t = xbn.shape[0]
        masks = clock_masks.unbind(0) if clock_masks is not None else [None] * t
        slices = zip(inp.unbind(0), att_in.unbind(0) if att_in is not None else [None] * t,
                     gi_in.unbind(0), masks)

        def step(p, xt, carry, tape=None):
            return _hgru_step(p, xt, carry, use_attention=self.use_attention, mxu=mxu)

        grad = torch.is_grad_enabled() and (
            xbn.requires_grad or any(q.requires_grad for q in self.parameters()))
        if grad and self.remat:
            step = recomputed(step, tuple(p), 2)
        zeros = torch.zeros(xbn.shape[1:], dtype=torch.float32, device=xbn.device)
        carry, excs, atts = (zeros, zeros), [], []
        for xt in slices:
            carry, att = step(p, xt, carry)
            if collect:
                excs.append(carry[1])
                atts.append(att)
        return carry[0], carry[1], excs, atts

    def _preproc(self, x):
        """x [B,3,T,H,W] -> the preproc's [T,B,H,W,C] (before its
        nonlinearity or norm)."""
        c = self.dimensions
        xc = x.permute(2, 0, 3, 4, 1)
        return dense(xc, self.preproc.weight.view(c, 3).t(), self.preproc.bias)


def _to_bt(seq):
    """A per-step list of [B,H,W,C] -> [B,T,C,H,W]."""
    return torch.stack(seq).permute(1, 0, 4, 2, 3)


class FFhGRU(_HGRUBase):
    """hGRU with attention and the target-conditioned readout
    (hgru.py:162-185; reference ffhgru_hierarchy.py:176-276)."""

    def __init__(self, *args, device=None, **kwargs):
        super().__init__(*args, **kwargs)
        common.make_readout(self, self.dimensions, self.gen)
        self.to(resolve_device(device))

    def forward(self, x, testmode: bool = False):
        xbn = softplus(self._preproc(x))
        _, exc, excs, atts = self._run(xbn, collect=testmode)
        logit = common.target_readout(self, exc, x[:, 2, 0])
        if testmode:
            states = torch.stack([common.readout_state_map(self, e) for e in excs])
            return logit, states.permute(1, 0, 4, 2, 3), _to_bt(atts)
        return logit, torch.ones((1,), device=x.device)


class ClockHGRU(_HGRUBase):
    """Clockwork hGRU (hgru.py:188-256): 'fixed' channel groups that update
    every 1, 2, 4, ... steps, or a 'dynamic' learned rate
    sigmoid(clock_rate) blending each update. The preproc is a 1x1x1 conv
    and a batch-stat BN (``preproc_bn``); the readout is a 1x1 conv per
    frame, the frames concatenated along the width and flattened into
    Linear(T*H*W, 1), so the clip's height and width are arguments."""

    def __init__(self, dimensions: int = 32, timesteps: int = 64,
                 kernel_size: int = 15, clock_type: str = "dynamic",
                 height: int = 32, width: int = 32, device=None, **kwargs):
        if clock_type not in ("fixed", "dynamic"):
            raise ValueError(f"clock_type must be 'fixed' or 'dynamic', got {clock_type!r}")
        super().__init__(dimensions, timesteps, kernel_size, **kwargs)
        c, gen = dimensions, self.gen
        self.clock_type = clock_type
        self.preproc_bn = nn.BatchNorm2d(c, eps=BN_EPS, track_running_stats=False)
        self.readout_conv = nn.utils.skip_init(nn.Conv2d, c, 1, 1)
        fill_(self.readout_conv.weight, init.torch_conv_default, gen)
        fill_(self.readout_conv.bias, init.torch_conv_bias(c), gen)
        feat = timesteps * height * width
        self.readout_dense = nn.utils.skip_init(nn.Linear, feat, 1)
        fill_(self.readout_dense.weight, init.torch_conv_default, gen)
        fill_(self.readout_dense.bias, init.torch_conv_bias(feat), gen)
        if clock_type == "dynamic":
            self.clock_rate = nn.Parameter(init.constant(2.0)(gen, (c,)))
        self.to(resolve_device(device))

    def clock_masks(self, t: int, device):
        c = self.dimensions
        if self.clock_type == "fixed":
            # Channels split evenly over log2-spaced periods 1, 2, 4, ...
            n_groups = max(1, min(t.bit_length() - 1 if t > 1 else 1, 8))
            group = (torch.arange(c, device=device) * n_groups) // c
            steps = torch.arange(t, device=device)[:, None]
            return (steps % (2 ** group)[None, :] == 0).float()
        return torch.sigmoid(self.clock_rate)[None, :].expand(t, c)

    def forward(self, x, testmode: bool = False):
        t, b, h, w = x.shape[2], x.shape[0], x.shape[3], x.shape[4]
        xbn = batch_norm(self._preproc(x), self.preproc_bn.weight, self.preproc_bn.bias)
        _, _, excs, atts = self._run(xbn, collect=True,
                                     clock_masks=self.clock_masks(t, x.device))
        conv = self.readout_conv
        states = dense(torch.stack(excs), conv.weight[:, :, 0, 0].t(), conv.bias)
        # torch.cat(states, -1).reshape(B, -1): flatten order (h, t, w).
        flat = states[..., 0].permute(1, 2, 0, 3).reshape(b, t * h * w)
        logit = dense(flat, self.readout_dense.weight.t(), self.readout_dense.bias)
        if testmode:
            return logit, states.permute(1, 0, 4, 2, 3), _to_bt(atts)
        return logit, torch.ones((1,), device=x.device)


class FFhGRUv2(_HGRUBase):
    """No-attention hGRU with the wide readout (hgru.py:259-273; reference
    ffhgru_hierarchy.py:279-362): cat(excitation, frame-0 channels 1:) ->
    Conv2d(C+2, 1, 1) -> global average pool."""

    use_attention = False

    def __init__(self, *args, device=None, **kwargs):
        super().__init__(*args, **kwargs)
        c = self.dimensions
        self.target_conv = nn.utils.skip_init(nn.Conv2d, c + 2, 1, 1)
        fill_(self.target_conv.weight, init.torch_conv_default, self.gen)
        fill_(self.target_conv.bias, init.constant(0.0), self.gen)
        self.to(resolve_device(device))

    def forward(self, x, testmode: bool = False):
        xbn = softplus(self._preproc(x))
        _, exc, excs, atts = self._run(xbn, collect=testmode)
        merged = torch.cat([exc, x[:, 1:, 0].permute(0, 2, 3, 1)], dim=-1)
        conv = self.target_conv
        logit = global_avg_pool(dense(merged, conv.weight[:, :, 0, 0].t(), conv.bias))
        if testmode:
            return logit, _to_bt(excs), _to_bt(atts)
        return logit, torch.ones((1,), device=x.device)
