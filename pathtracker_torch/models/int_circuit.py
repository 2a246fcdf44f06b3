"""The InT gated recurrent circuit (pathtracker_tpu/models/int_circuit.py).

Per-step dynamics (reference models/InT.py:145-179), state = (inh, exc):

    att   = sigmoid(a_w(x_t) + a_u(exc))                  # attention spotlight
    g_exc = att * exc
    inh~  = sp(x_t - sp(BN0(conv(g_exc, w_inh)) * (alpha*inh + mu)))
    g_i   = sigmoid(i_w(x_t) + i_u(inh))
    inh'  = (1-g_i)*inh + g_i*inh~
    g_e   = sigmoid(e_w(inh) + e_u(g_exc))                # uses the OLD inh
    exc~  = sp(BN1(conv(inh', w_exc)) * (kappa*inh' + gamma))
    exc'  = (1-g_e)*exc + g_e*exc~

with a 1x1x1 Conv3d+softplus preproc before the loop and the
target-conditioned readout after it. ``no_inh`` collapses the inhibition
branch; the four lesion switches freeze alpha/mu/gamma/kappa at 0.

Layout: the state lives channels-last ([B,H,W,C], equivalently [B*H*W, C]
rows) throughout. cuDNN convolves it as a channels-last NCHW view with no
copy, and the fused kernels read the same storage as rows. The
input-dependent projections a_w(x_t), i_w(x_t) and the preproc are hoisted
out of the loop into time-major [T,B,H,W,C] matmuls; on the mixed path they
are stored bf16 (int_circuit.py:302-319), while the carry, the BN
statistics and the readout stay f32. A pure-bf16 carry never leaves the
chance plateau (int_circuit.py:237-245), so there is none.

Two cells, chosen from the config alone before anything launches:
  * the eager cell (``_int_cell_step``): every config, f32 or mixed bf16 —
    the f32 parity path, the lesion/no_inh/no-attention/tanh variants, and
    the oracle the kernels are held against;
  * the fused cell (``_int_cell_step_fused``): the mixed-bf16 default config
    (attention, inhibition, softplus, no lesions), with the three
    elementwise/gate phases in hand-written CUDA kernels (ops/int_fused.py).
    The JAX package keeps it off (int_circuit.py:226-236) because on the TPU
    the packed<->spatial relayouts at the convs cost 5x; here the state is
    channels-last for both convs and kernels, so there is no relayout and
    ``fused`` defaults to True.
"""

from __future__ import annotations

import torch
from torch import nn

from pathtracker_torch import resolve_device
from pathtracker_torch.models import common
from pathtracker_torch.models.common import fill_
from pathtracker_torch.ops import initializers as init
from pathtracker_torch.ops import int_fused as F
from pathtracker_torch.ops.layers import batch_norm, conv2d, dense, softplus

_NL = {"softplus": softplus, "tanh": torch.tanh}
_LESIONS = ("alpha", "mu", "gamma", "kappa")


def _int_cell_step(cp, xt, carry, *, use_attention, no_inh, act, mxu):
    """One rCell step on [B,H,W,C] tensors (int_circuit.py:150-194).
    Returns ((new_inh, new_exc), att)."""
    inp, att_x, gi_x = xt
    inh, exc = carry

    def fdense(z, kern, bias):
        return dense(z, kern, bias, mxu_dtype=mxu)

    def fconv(z, kern):
        y = conv2d(z, kern, mxu_dtype=mxu, keep_mxu_dtype=True)
        return y.float() if mxu is not None else y

    if use_attention:
        att = torch.sigmoid(att_x + fdense(exc, cp["a_u"], cp["a_u_b"]))
        gated_exc = att * exc
    else:
        att = torch.ones_like(exc)
        gated_exc = exc
    if not no_inh:
        inh_intx = batch_norm(fconv(gated_exc, cp["w_inh"]),
                              cp["bn0_scale"], cp["bn0_bias"])
        inh_hat = act(inp - act(inh_intx * (cp["alpha"] * inh + cp["mu"])))
        g_i = torch.sigmoid(gi_x + fdense(inh, cp["i_u"], cp["i_u_b"]))
        new_inh = (1.0 - g_i) * inh + g_i * inh_hat
        gate_inh_ref = inh  # e-gate reads the pre-update inhibition
    else:
        new_inh = gated_exc
        gate_inh_ref = exc  # reference models/InT.py:168
    g_e = torch.sigmoid(fdense(gate_inh_ref, cp["e_w"], cp["e_w_b"])
                        + fdense(gated_exc, cp["e_u"], cp["e_u_b"]))
    exc_intx = batch_norm(fconv(new_inh, cp["w_exc"]),
                          cp["bn1_scale"], cp["bn1_bias"])
    exc_hat = act(exc_intx * (cp["kappa"] * new_inh + cp["gamma"]))
    new_exc = (1.0 - g_e) * exc + g_e * exc_hat
    return (new_inh, new_exc), att


def _conv_rows(z_rows, weight, shape):
    """k x k conv of [R, C] rows viewed as [B,H,W,C]; bf16 out, as rows."""
    y = conv2d(z_rows.view(shape), weight, mxu_dtype=torch.bfloat16,
               keep_mxu_dtype=True)
    return y.reshape(-1, shape[-1]).contiguous()


def _int_cell_step_fused(cp, xt, carry, shape):
    """The mixed-bf16 default cell on [R, C] rows (int_circuit.py:59-99):
    K1, conv, BN0 stats, K2, conv, BN1 stats, K3."""
    c = shape[-1]
    inp, att_x, gi_x = (z.reshape(-1, c) for z in xt)
    inh, exc = carry
    gated, att = F.k1_attention(exc, att_x, cp["a_u"], cp["a_u_b"])
    conv_i = _conv_rows(gated, cp["w_inh"], shape)
    mean0, rstd0 = F.stats(conv_i)
    new_inh = F.k2_inhibition(
        conv_i, mean0, rstd0, cp["bn0_scale"], cp["bn0_bias"], inp, gi_x, inh,
        cp["i_u"], cp["i_u_b"], cp["alpha"], cp["mu"])
    conv_e = _conv_rows(new_inh, cp["w_exc"], shape)
    mean1, rstd1 = F.stats(conv_e)
    new_exc = F.k3_excitation(
        conv_e, mean1, rstd1, cp["bn1_scale"], cp["bn1_bias"], new_inh, inh,
        gated, exc, cp["e_w"], cp["e_w_b"], cp["e_u"], cp["e_u_b"],
        cp["kappa"], cp["gamma"])
    return (new_inh, new_exc), att


class RCell(nn.Module):
    """The recurrent cell's parameters (reference models/InT.py rCell :58),
    named after the reference state_dict (``unit1.*``): 1x1 gate convs,
    OIHW k x k kernels, [C,1,1] per-channel scalars and two batch-stat BNs
    (``bn.0``, ``bn.1``; only their affine parameters are used)."""

    def __init__(self, c, k, timesteps, use_attention, no_inh, lesions, gen):
        super().__init__()

        def gate(name, bias_init):
            conv = nn.utils.skip_init(nn.Conv2d, c, c, 1)
            fill_(conv.weight, init.torch_orthogonal, gen)
            fill_(conv.bias, bias_init, gen)
            setattr(self, name, conv)
            return conv

        def scalar(name, value):
            setattr(self, name, nn.Parameter(init.constant(value)(gen, (c, 1, 1))))

        if use_attention:
            gate("a_w_gate", init.constant(1.0))
            gate("a_u_gate", init.constant(1.0))
            # Gate biases tied to the negated attention bias at init
            # (reference models/InT.py:121-125).
            for name in ("i_w_gate", "i_u_gate", "e_w_gate", "e_u_gate"):
                gate(name, init.constant(-1.0))
        else:
            # Chrono-style init (reference intent at models/InT.py:127-131).
            i_w = gate("i_w_gate", init.chrono_gate_bias(timesteps))
            i_u = gate("i_u_gate", init.chrono_gate_bias(timesteps))
            gate("e_w_gate", lambda g, s: -i_w.bias.detach())
            gate("e_u_gate", lambda g, s: -i_u.bias.detach())

        self.w_exc = nn.Parameter(init.torch_orthogonal(gen, (c, c, k, k)))
        if not no_inh:
            self.w_inh = nn.Parameter(init.torch_orthogonal(gen, (c, c, k, k)))
            if "alpha" not in lesions:
                scalar("alpha", 1.0)
            if "mu" not in lesions:
                scalar("mu", 0.0)
        if "gamma" not in lesions:
            scalar("gamma", 0.0)
        if "kappa" not in lesions:
            scalar("kappa", 1.0)
        # `w` exists in the reference cell but its forward never reads it
        # (reference models/InT.py:100); kept for checkpoint parity.
        scalar("w", 1.0)
        self.bn = nn.ModuleList(
            nn.BatchNorm2d(c, eps=F.BN_EPS, track_running_stats=False)
            for _ in range(2))
        for bn in self.bn:
            fill_(bn.weight, init.constant(0.1), gen)
            fill_(bn.bias, init.constant(0.0), gen)


class InT(nn.Module):
    """InT: preproc -> T cell steps -> target-conditioned readout.

    Contract (reference models/InT.py:210-245):
      forward(x [B,3,T,H,W]) -> (logit [B,1], jv_penalty [1])
      forward(x, testmode=True) -> (logit, states [B,T,1,H,W], gates [B,T,C,H,W])

    ``dtype='float32'`` runs everything in f32 (reference parity);
    ``'bfloat16'`` is the mixed path: bf16 operands into the convs and 1x1
    matmuls with f32 accumulation, f32 carry, BN statistics and readout.
    Parameters are drawn from ``torch.Generator().manual_seed(seed)`` and
    placed on ``device`` (``None`` means cuda).
    """

    def __init__(self, dimensions: int = 32, timesteps: int = 64,
                 kernel_size: int = 7, use_attention: bool = True,
                 no_inh: bool = False, lesion_alpha: bool = False,
                 lesion_mu: bool = False, lesion_gamma: bool = False,
                 lesion_kappa: bool = False, nl: str = "softplus",
                 fused: bool = True, dtype: str = "float32", seed: int = 0,
                 device=None):
        super().__init__()
        if nl not in _NL:
            raise ValueError(f"nl must be one of {sorted(_NL)}, got {nl!r}")
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', got {dtype!r}")
        c = dimensions
        self.dimensions, self.timesteps = c, timesteps
        self.use_attention, self.no_inh, self.nl = use_attention, no_inh, nl
        flags = (lesion_alpha, lesion_mu, lesion_gamma, lesion_kappa)
        self.lesions = frozenset(n for n, on in zip(_LESIONS, flags) if on)
        self.mxu = torch.bfloat16 if dtype == "bfloat16" else None
        # The fused kernels cover exactly the JAX package's fused configs
        # (int_circuit.py:340-345); every other config runs the eager cell.
        self.use_fused = (fused and self.mxu is not None and use_attention
                          and not no_inh and nl == "softplus"
                          and not self.lesions and F.supported(c))

        gen = torch.Generator().manual_seed(seed)
        self.preproc = nn.utils.skip_init(nn.Conv3d, 3, c, 1)
        fill_(self.preproc.weight, init.torch_conv_default, gen)
        fill_(self.preproc.bias, init.torch_conv_bias(3), gen)
        self.unit1 = RCell(c, kernel_size, timesteps, use_attention, no_inh,
                           self.lesions, gen)
        common.make_readout(self, c, gen)
        self.to(resolve_device(device))

    def _cell_params(self):
        """The cell's parameters in the step functions' layouts: gate
        kernels [Cin, Cout] and k x k kernels cast once per forward to the
        matmul dtype (bf16 on the mixed path), per-channel vectors [C], and
        0.0 for lesioned scalars."""
        cell = self.unit1
        wdt = self.mxu or torch.float32

        def kern(name):
            return getattr(cell, name).weight[:, :, 0, 0].t().to(wdt).contiguous()

        def bias(name):
            return getattr(cell, name).bias

        def scalar(name):
            return getattr(cell, name).view(-1) if name not in self.lesions else 0.0

        cp = dict(i_u=kern("i_u_gate"), i_u_b=bias("i_u_gate"),
                  e_w=kern("e_w_gate"), e_w_b=bias("e_w_gate"),
                  e_u=kern("e_u_gate"), e_u_b=bias("e_u_gate"),
                  gamma=scalar("gamma"), kappa=scalar("kappa"),
                  w_exc=cell.w_exc.to(wdt),
                  bn1_scale=cell.bn[1].weight, bn1_bias=cell.bn[1].bias)
        if self.use_attention:
            cp.update(a_u=kern("a_u_gate"), a_u_b=bias("a_u_gate"))
        if not self.no_inh:
            cp.update(w_inh=cell.w_inh.to(wdt), alpha=scalar("alpha"),
                      mu=scalar("mu"), bn0_scale=cell.bn[0].weight,
                      bn0_bias=cell.bn[0].bias)
        return cp

    def forward(self, x, testmode: bool = False):
        c = self.dimensions
        act = _NL[self.nl]
        mxu = self.mxu
        cell = self.unit1

        def fdense(z, gate):
            return dense(z, gate.weight[:, :, 0, 0].t(), gate.bias, mxu_dtype=mxu)

        def store(z):
            return z.to(mxu) if mxu is not None else z

        # ---- preproc + hoisted input projections, time-major [T,B,H,W,C] ----
        xc = x.permute(2, 0, 3, 4, 1)
        t, b, h, w, _ = xc.shape
        pre = self.preproc
        xbn = act(dense(xc, pre.weight.view(c, 3).t(), pre.bias, mxu_dtype=mxu))
        att_in = store(fdense(xbn, cell.a_w_gate)) if self.use_attention else None
        gi_in = store(fdense(xbn, cell.i_w_gate))
        inp = store(xbn)
        del xbn

        cp = self._cell_params()
        shape = (b, h, w, c)
        zeros = torch.zeros(shape, dtype=torch.float32, device=x.device)
        if self.use_fused:
            zeros = zeros.view(-1, c)
        carry = (zeros, zeros)
        states, gates = [], []
        for i in range(t):
            xt = (inp[i], att_in[i] if att_in is not None else None, gi_in[i])
            if self.use_fused:
                carry, att = _int_cell_step_fused(cp, xt, carry, shape)
            else:
                carry, att = _int_cell_step(
                    cp, xt, carry, use_attention=self.use_attention,
                    no_inh=self.no_inh, act=act, mxu=mxu)
            if testmode:
                states.append(common.readout_state_map(self, carry[1].view(shape)))
                gates.append(att.view(shape))

        exc = carry[1].view(shape)
        target_frame = x[:, 2, 0]  # blue channel of frame 0
        logit = common.target_readout(self, exc, target_frame).float()
        if testmode:
            states = torch.stack(states).permute(1, 0, 4, 2, 3)  # [B,T,1,H,W]
            gates = torch.stack(gates).permute(1, 0, 4, 2, 3)  # [B,T,C,H,W]
            return logit, states, gates
        return logit, torch.ones((1,), device=x.device)
