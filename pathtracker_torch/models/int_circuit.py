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

Training: when a gradient is asked for, each step runs through
``_RecomputedStep``, which saves the step's inputs (the f32 carry, the three
hoisted slices, the cell parameters) and the outputs ``remat_policy`` keeps,
and re-runs the step in backward, so a step's other residuals live only while
its own backward runs. The fused cell keeps nothing more and recomputes the
whole step (int_circuit.py:102-125); the eager cell follows the JAX
package's policies (:218-225, :373-384): ``'conv'`` (the default) keeps the
step's two conv outputs and the recompute replays only the elementwise and
gate chain, ``'conv_gates'`` also keeps the four gate matmul outputs,
``'full'`` keeps nothing more, and ``remat=False`` stores everything. The
kernels' backward halves are hand-written too (ops/int_fused.py); the convs'
backward is cuDNN's and the BN statistics' is autograd's.

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

import functools

import torch
import torch.nn.functional as TF
from torch import nn
from torch.autograd.function import once_differentiable

from pathtracker_torch import resolve_device
from pathtracker_torch.models import common
from pathtracker_torch.models.common import fill_
from pathtracker_torch.ops import initializers as init
from pathtracker_torch.ops import int_fused as F
from pathtracker_torch.ops.layers import batch_norm, conv2d, dense, softplus
from pathtracker_torch.ops.rbp import neumann_rbp

_NL = {"softplus": softplus, "tanh": torch.tanh}
_LESIONS = ("alpha", "mu", "gamma", "kappa")
# What each remat policy of the eager cell keeps of a step besides its
# inputs, by the JAX package's checkpoint names (int_circuit.py:157-170).
_REMAT_KEEPS = {"full": frozenset(), "conv": frozenset({"cell_conv"}),
                "conv_gates": frozenset({"cell_conv", "cell_gate"})}


def _conv_vjp(dy, a, b, needs, padding, groups):
    """(da, db) of ``F.conv2d(a, b, padding=padding, groups=groups)``
    (stride 1) from its output's cotangent ``dy``: the call autograd's
    ConvolutionBackward makes, after the explicit pad 'same' takes for an
    even kernel."""
    k = b.shape[-1]
    if padding != "same" or b.shape[-2] != k:
        raise ValueError(f"a saved conv takes square kernels, padding 'same': {padding!r}")
    left, extra = (k - 1) // 2, (k - 1) % 2
    a_pad = TF.pad(a, (0, extra, 0, extra)) if extra else a
    da, db, _ = torch.ops.aten.convolution_backward(
        dy, a_pad, b, None, [1, 1], [left, left], [1, 1], False, [0, 0],
        groups, [needs[0], needs[1], False])
    if extra and da is not None:
        da = da[..., :a.shape[-2], :a.shape[-1]]
    return da, db


def _matmul_vjp(dy, a, b, needs):
    """(da, db) of ``a @ b``, ``a`` [..., n] and ``b`` [n, m] row-major, as
    autograd's MmBackward computes them on the rows of ``a``."""
    rows, dy2 = a.reshape(-1, a.shape[-1]), dy.reshape(-1, dy.shape[-1])
    da = dy2.mm(b.t()).view(a.shape) if needs[0] else None
    db = rows.t().mm(dy2) if needs[1] else None
    return da, db


class _Kept(torch.autograd.Function):
    """Stands for ``op(a, b)`` in a step's recompute: returns the output
    saved in the step's forward and pulls its cotangent back through ``op``'s
    VJP, ``vjp(dy, a, b, needs)``."""

    @staticmethod
    def forward(ctx, vjp, y, a, b):
        ctx.vjp = vjp
        ctx.save_for_backward(a, b)
        return y.view_as(y)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        return (None, None, *ctx.vjp(dy, a, b, ctx.needs_input_grad[2:]))


class _Tape:
    """The products a remat policy keeps of one step (``keep``, of the
    names 'cell_conv' and 'cell_gate'): recorded when ``saved`` is None (the
    step's forward), else handed back in order (its recompute in backward)."""

    def __init__(self, keep, saved=None):
        self.keep = keep
        self.recorded = []
        self._saved = None if saved is None else iter(saved)

    def op(self, name, fn, vjp):
        """``fn`` (``F.conv2d`` or ``torch.matmul``) as the tape's step calls it."""
        if name not in self.keep:
            return fn

        def call(a, b, **kw):
            if self._saved is None:
                y = fn(a, b, **kw)
                self.recorded.append(y)
                return y
            return _Kept.apply(functools.partial(vjp, **kw), next(self._saved), a, b)
        return call


def _int_cell_step(cp, xt, carry, *, use_attention, no_inh, act, mxu, tape=None):
    """One rCell step on [B,H,W,C] tensors (int_circuit.py:150-194).
    Returns ((new_inh, new_exc), att). ``tape`` records or hands back the
    conv and gate products a remat policy keeps."""
    inp, att_x, gi_x = xt
    inh, exc = carry
    conv, matmul = TF.conv2d, torch.matmul
    if tape is not None:
        conv = tape.op("cell_conv", conv, _conv_vjp)
        matmul = tape.op("cell_gate", matmul, _matmul_vjp)

    def fdense(z, kern, bias):
        return dense(z, kern, bias, mxu_dtype=mxu, matmul=matmul)

    def fconv(z, kern):
        y = conv2d(z, kern, mxu_dtype=mxu, keep_mxu_dtype=True, conv=conv)
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
    K1, conv, BN0 stats, K2, conv, BN1 stats, K3. The gate matrices are cast
    to bf16 here: no work when ``cp`` holds them in bf16 already (no
    gradient asked for), and one f32 gradient per step when it holds the f32
    parameters."""
    c = shape[-1]
    bf16 = torch.bfloat16
    inp, att_x, gi_x = (z.reshape(-1, c) for z in xt)
    inh, exc = carry
    gated, att = F.k1_attention(exc, att_x, cp["a_u"].to(bf16), cp["a_u_b"])
    conv_i = _conv_rows(gated, cp["w_inh"], shape)
    mean0, rstd0 = F.stats(conv_i)
    new_inh = F.k2_inhibition(
        conv_i, mean0, rstd0, cp["bn0_scale"], cp["bn0_bias"], inp, gi_x, inh,
        cp["i_u"].to(bf16), cp["i_u_b"], cp["alpha"], cp["mu"])
    conv_e = _conv_rows(new_inh, cp["w_exc"], shape)
    mean1, rstd1 = F.stats(conv_e)
    new_exc = F.k3_excitation(
        conv_e, mean1, rstd1, cp["bn1_scale"], cp["bn1_bias"], new_inh, inh,
        gated, exc, cp["e_w"].to(bf16), cp["e_w_b"], cp["e_u"].to(bf16),
        cp["e_u_b"], cp["kappa"], cp["gamma"])
    return (new_inh, new_exc), att


class _RecomputedStep(torch.autograd.Function):
    """``fn(*args, tape=...) -> tuple of tensors`` that saves ``args`` and
    the products ``keep`` names (``_Tape``), and in backward runs ``fn``
    again with grad enabled, the kept products handed back, and pulls the
    cotangents through it (int_circuit.py:109-125, :373-384). Non-tensor
    arguments pass through and get no gradient."""

    @staticmethod
    def forward(ctx, fn, keep, *args):
        tape = _Tape(keep)
        out = fn(*args, tape=tape)
        ctx.fn, ctx.keep = fn, keep
        ctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
        ctx.consts = [a for a in args if not isinstance(a, torch.Tensor)]
        ctx.n_kept = len(tape.recorded)
        ctx.save_for_backward(*(a for a in args if isinstance(a, torch.Tensor)),
                              *tape.recorded)
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, *cotangents):
        n_args = len(ctx.saved_tensors) - ctx.n_kept
        saved, consts = iter(ctx.saved_tensors[:n_args]), iter(ctx.consts)
        args = [next(saved).detach().requires_grad_(need) if is_tensor
                else next(consts)
                for is_tensor, need in zip(ctx.is_tensor, ctx.needs_input_grad[2:])]
        wanted = [is_tensor and a.requires_grad
                  for a, is_tensor in zip(args, ctx.is_tensor)]
        leaves = [a for a, want in zip(args, wanted) if want]
        with torch.enable_grad():
            outs = ctx.fn(*args, tape=_Tape(ctx.keep, ctx.saved_tensors[n_args:]))
        pairs = [(o, d) for o, d in zip(outs, cotangents)
                 if d is not None and o.requires_grad]
        if not (pairs and leaves):
            return (None,) * (2 + len(args))
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], leaves, [d for _, d in pairs],
            allow_unused=True))
        return (None, None, *(next(grads) if want else None for want in wanted))


def recomputed(step, names, n_carry: int, keep=frozenset()):
    """``step(cp, xt, carry, tape=None) -> (carry, aux)`` as a step that goes
    through ``_RecomputedStep``: ``cp`` a dict over ``names``, ``carry`` a
    tuple of ``n_carry`` tensors, ``keep`` what the remat policy keeps."""
    def flat(*args, tape):
        carry, aux = step(dict(zip(names, args)), args[len(names):-n_carry],
                          args[-n_carry:], tape)
        return (*carry, aux)

    def wrapped(cp, xt, carry):
        *carry, aux = _RecomputedStep.apply(flat, keep, *(cp[n] for n in names),
                                            *xt, *carry)
        return tuple(carry), aux
    return wrapped


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
    ``remat`` and ``remat_policy`` (the eager cell only; the fused cell
    always recomputes the whole step, as in JAX): with ``remat`` each step
    is recomputed in backward from its inputs and what the policy keeps, as
    the JAX package's policies (int_circuit.py:218-225): ``'conv'`` the two
    k x k conv outputs, ``'conv_gates'`` also the four gate matmul outputs,
    ``'full'`` nothing more. ``remat=False`` stores everything. Gradients
    are the same under all of them.
    Parameters are drawn from ``torch.Generator().manual_seed(seed)`` and
    placed on ``device`` (``None`` means cuda).
    """

    def __init__(self, dimensions: int = 32, timesteps: int = 64,
                 kernel_size: int = 7, use_attention: bool = True,
                 no_inh: bool = False, lesion_alpha: bool = False,
                 lesion_mu: bool = False, lesion_gamma: bool = False,
                 lesion_kappa: bool = False, nl: str = "softplus",
                 fused: bool = True, remat: bool = True,
                 remat_policy: str = "conv", dtype: str = "float32",
                 grad_method: str = "bptt", seed: int = 0, device=None):
        super().__init__()
        if nl not in _NL:
            raise ValueError(f"nl must be one of {sorted(_NL)}, got {nl!r}")
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', got {dtype!r}")
        if remat_policy not in _REMAT_KEEPS:
            raise ValueError(f"remat_policy must be one of {sorted(_REMAT_KEEPS)}, "
                             f"got {remat_policy!r}")
        c = dimensions
        self.dimensions, self.timesteps = c, timesteps
        self.use_attention, self.no_inh, self.nl = use_attention, no_inh, nl
        flags = (lesion_alpha, lesion_mu, lesion_gamma, lesion_kappa)
        self.lesions = frozenset(n for n, on in zip(_LESIONS, flags) if on)
        self.mxu = torch.bfloat16 if dtype == "bfloat16" else None
        self.remat, self.remat_policy = remat, remat_policy
        self.grad_method = grad_method
        # The fused kernels cover exactly the JAX package's fused configs
        # (int_circuit.py:340-345); every other config runs the eager cell.
        self.use_fused = (fused and self.mxu is not None and use_attention
                          and not no_inh and nl == "softplus"
                          and not self.lesions and "rbp" not in grad_method
                          and F.supported(c))

        gen = torch.Generator().manual_seed(seed)
        self.preproc = nn.utils.skip_init(nn.Conv3d, 3, c, 1)
        fill_(self.preproc.weight, init.torch_conv_default, gen)
        fill_(self.preproc.bias, init.torch_conv_bias(3), gen)
        self.unit1 = RCell(c, kernel_size, timesteps, use_attention, no_inh,
                           self.lesions, gen)
        common.make_readout(self, c, gen)
        self.to(resolve_device(device))

    def _cell_params(self, cast: bool):
        """The cell's parameters in the step functions' layouts: gate
        kernels [Cin, Cout] and k x k kernels, per-channel vectors [C], and
        0.0 for lesioned scalars. With ``cast`` the kernels are cast once
        per forward to the matmul dtype (bf16 on the mixed path). Without
        it they stay f32 and the step casts them: each step then hands back
        an f32 gradient and the sum over the T steps is taken in f32, as
        the JAX package's in-step casts have it."""
        cell = self.unit1
        wdt = (self.mxu or torch.float32) if cast else torch.float32

        def kern(name):
            return getattr(cell, name).weight[:, :, 0, 0].t().contiguous().to(wdt)

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

    def _rbp(self, cp, slices, carry, act):
        """Neumann RBP over the eager cell (int_circuit.py:389-411): the
        first T-1 steps without gradient, the last one through
        ``neumann_rbp`` with 15 terms at most. Returns the last carry."""
        kw = dict(use_attention=self.use_attention, no_inh=self.no_inh,
                  act=act, mxu=self.mxu)
        with torch.no_grad():
            for xt in slices[:-1]:
                carry, _ = _int_cell_step(cp, xt, carry, **kw)
        names = [k for k, v in cp.items() if isinstance(v, torch.Tensor)]
        consts = {k: v for k, v in cp.items() if not isinstance(v, torch.Tensor)}
        last = slices[-1]
        present = [i for i, z in enumerate(last) if z is not None]

        def rbp_step(aux, state):
            cp_ = dict(consts, **dict(zip(names, aux)))
            xt = [None] * len(last)
            for i, z in zip(present, aux[len(names):]):
                xt[i] = z
            new_carry, _ = _int_cell_step(cp_, tuple(xt), tuple(state), **kw)
            return new_carry

        aux = tuple(cp[k] for k in names) + tuple(last[i] for i in present)
        return neumann_rbp(rbp_step, aux, carry, 15)

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

        grad = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))
        cp = self._cell_params(cast=not grad)
        shape = (b, h, w, c)
        zeros = torch.zeros(shape, dtype=torch.float32, device=x.device)
        if self.use_fused:
            zeros = zeros.view(-1, c)

            keep = frozenset()  # the fused cell recomputes the whole step

            def step(cp, xt, carry, tape=None):
                return _int_cell_step_fused(cp, xt, carry, shape)
        else:
            keep = _REMAT_KEEPS[self.remat_policy]

            def step(cp, xt, carry, tape=None):
                return _int_cell_step(
                    cp, xt, carry, use_attention=self.use_attention,
                    no_inh=self.no_inh, act=act, mxu=mxu, tape=tape)
        if grad and (self.use_fused or self.remat):
            step = recomputed(step, tuple(cp), 2, keep)
        carry = (zeros, zeros)
        states, gates = [], []
        # unbind, not inp[i]: one stacked gradient per projection in backward
        # instead of T full-size zero-filled ones.
        slices = list(zip(inp.unbind(0),
                          att_in.unbind(0) if att_in is not None else [None] * t,
                          gi_in.unbind(0)))
        if "rbp" in self.grad_method and not testmode:
            carry = self._rbp(cp, slices, carry, act)
            slices = []
        for xt in slices:
            carry, att = step(cp, xt, carry)
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


class FC(nn.Module):
    """Linear probe baseline (int_circuit.py:431-458; reference
    models/InT.py:248-271): 1x1x1 Conv3d preproc -> batch-stat BatchNorm3d
    -> flatten in BCTHW order -> Linear(T*C*H*W, 1). The clip's height and
    width fix the readout's width, so they are arguments here."""

    def __init__(self, dimensions: int = 32, timesteps: int = 64,
                 kernel_size: int = 15, height: int = 32, width: int = 32,
                 grad_method: str = "bptt", seed: int = 0, device=None):
        super().__init__()
        c = dimensions
        self.dimensions, self.timesteps = c, timesteps
        self.grad_method = grad_method
        gen = torch.Generator().manual_seed(seed)
        self.preproc = nn.utils.skip_init(nn.Conv3d, 3, c, 1)
        fill_(self.preproc.weight, init.torch_conv_default, gen)
        fill_(self.preproc.bias, init.torch_conv_bias(3), gen)
        self.bn = nn.BatchNorm3d(c, eps=F.BN_EPS, track_running_stats=False)
        feat = timesteps * c * height * width
        self.readout = nn.utils.skip_init(nn.Linear, feat, 1)
        fill_(self.readout.weight, init.torch_conv_default, gen)
        fill_(self.readout.bias, init.torch_conv_bias(feat), gen)
        self.to(resolve_device(device))

    def forward(self, x, testmode: bool = False):
        c = self.dimensions
        xc = x.permute(0, 2, 3, 4, 1)  # [B,T,H,W,3]
        z = dense(xc, self.preproc.weight.view(c, 3).t(), self.preproc.bias)
        z = batch_norm(z, self.bn.weight, self.bn.bias)
        z = z.permute(0, 4, 1, 2, 3).reshape(x.shape[0], -1)  # BCTHW order
        logit = dense(z, self.readout.weight.t(), self.readout.bias)
        if testmode:  # a probe has no recurrent state to show
            return logit, None, None
        return logit, torch.ones((1,), device=x.device)
