"""The InT cell's three fused elementwise/gate phases, forward and backward
(pathtracker_tpu/ops/int_fused.py).

The cell step (reference models/InT.py:145-179) splits into three phases
interleaved with the two k x k convs, which stay with cuDNN:

    K1  att = sigmoid(att_x + exc @ a_u + b);  gated_exc = att * exc
        -> conv_i = conv(gated_exc, w_inh); BN0 stats            [PyTorch]
    K2  bn0 = (conv_i - mean0) * rstd0 * scale0 + bias0
        inh_hat = sp(inp - sp(bn0 * (alpha * inh + mu)))
        g_i = sigmoid(gi_x + inh @ i_u + b)
        new_inh = (1 - g_i) * inh + g_i * inh_hat
        -> conv_e = conv(new_inh, w_exc); BN1 stats              [PyTorch]
    K3  g_e = sigmoid(inh @ e_w + b_w + gated_exc @ e_u + b_u)   (OLD inh)
        exc_hat = sp(bn1 * (kappa * new_inh + gamma))
        new_exc = (1 - g_e) * exc + g_e * exc_hat

Tensors are unpacked channels-last rows: [R, C] with R = B*H*W, [C, C] gate
matrices (input channel first, as ``dense`` kernels) and [C] per-channel
vectors. The JAX kernels' 128-lane packing and block-diagonal matrices are
a TPU layout trick; only the math is ported. Gate products take
bf16-rounded operands with f32 accumulation; all elementwise math is f32;
softplus is ``jax.nn.softplus``'s logaddexp form, not the eager cell's
thresholded one.

Each phase has, forward and backward, a plain PyTorch version and a wrapper.
A wrapper checks its inputs, then takes the plain version for CPU tensors
and launches the hand-written CUDA kernel (csrc/int_cell.cu forward,
csrc/int_cell_bwd.cu backward) for CUDA tensors, raising if the launch
fails. ``<wrapper>.launches`` counts kernel launches only. The backward
versions are hand-derived like the Pallas ones, not autograd of the forward:
they recompute the phase from its inputs and round where the Pallas bodies
round. A backward launch returns finished gradients: its sums over the rows
are completed on the card by the same call, so a backward wrapper does no
arithmetic of its own. ``k1_attention``, ``k2_inhibition`` and
``k3_excitation`` are differentiable: given an input that requires grad they
go through a ``torch.autograd.Function`` whose backward is the backward
wrapper.

The three forward phases are also registered as ``torch.library`` custom
ops (``torch.ops.pathtracker.k1_attention`` etc.): the checks, the launch
(or the plain version on the CPU) and the launch count are the op's real
implementation (``_k1_impl`` ...), and its fake one gives the output shapes
and dtypes. Under ``torch.export`` (eval/serve.py) or ``torch.compile`` a
forward call goes through the op, so the program records a call to it, not
the traced plain version, and no shape check puts a guard on a symbolic
batch; an eager call runs the real implementation directly and skips the
op's dispatch: 26-35 us of host time a call beside an NVIDIA H100 80GB
HBM3 (700 W), which the host-bound train step pays 6T times, +9.5-16.9% at
its median (scripts/torch_dispatch_cost.py). A program that loads such an
export needs this module imported, which registers the ops.
"""

from __future__ import annotations

import torch
from torch import Tensor
from torch.autograd.function import once_differentiable

from pathtracker_torch.ops import _native

C = 32  # the channel width the CUDA kernels are written for
BN_EPS = 1e-3  # reference BN eps (InT cells)

_F32, _BF16 = torch.float32, torch.bfloat16


def supported(c: int) -> bool:
    """Whether the fused kernels take a cell of ``c`` channels. Any row
    count is taken: the kernels mask the ragged last tile."""
    return c == C


def stats(conv_out):
    """Batch-stat f32 mean and rstd per channel of a [R, C] conv output,
    from E[x²]−E[x]² (int_fused.py:501-508). Plain PyTorch, outside the
    kernels, as the JAX package leaves it to XLA."""
    x = conv_out.float()
    mean = x.mean(dim=0)
    var = x.square().mean(dim=0) - mean.square()
    return mean, torch.rsqrt(var + BN_EPS)


# ----------------------------- plain versions -------------------------------

def _dot(a, w):
    """[R, C] @ [C, C]: bf16-rounded operands, f32 accumulation."""
    return a.to(_BF16).float() @ w.float()


def _sp(x):
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def k1_attention_plain(exc, att_x, a_u, a_u_b):
    pre = att_x.float() + _dot(exc, a_u) + a_u_b
    att = torch.sigmoid(pre)
    return (att * exc).to(_BF16), att


def k2_inhibition_plain(conv_i, mean0, rstd0, scale0, bias0, inp, gi_x, inh,
                        i_u, i_u_b, alpha, mu):
    xn = (conv_i.float() - mean0) * rstd0
    bn0 = xn * scale0 + bias0
    t1 = bn0 * (alpha * inh + mu)
    inh_hat = _sp(inp.float() - _sp(t1))
    g = torch.sigmoid(gi_x.float() + _dot(inh, i_u) + i_u_b)
    return (1.0 - g) * inh + g * inh_hat


def k3_excitation_plain(conv_e, mean1, rstd1, scale1, bias1, new_inh, inh,
                        gated, exc, e_w, e_w_b, e_u, e_u_b, kappa, gamma):
    xn = (conv_e.float() - mean1) * rstd1
    bn1 = xn * scale1 + bias1
    exc_hat = _sp(bn1 * (kappa * new_inh + gamma))
    g = torch.sigmoid(_dot(inh, e_w) + e_w_b + _dot(gated.float(), e_u) + e_u_b)
    return (1.0 - g) * exc + g * exc_hat


def _dot_t(d, w):
    """[R, C] @ [C, C]^T: bf16-rounded operands, f32 accumulation."""
    return d.to(_BF16).float() @ w.float().t()


def _wgrad(x, d, dtype):
    """x^T @ d -> [C, C]: both operands rounded to bf16, f32 accumulation,
    the sum rounded once to the weight operand's ``dtype``. (The Pallas
    kernels round each of four block-diagonal copies and then sum them, so
    the two can differ by a bf16 ulp.)"""
    return (x.to(_BF16).float().t() @ d.to(_BF16).float()).to(dtype)


def k1_attention_bwd_plain(exc, att_x, a_u, a_u_b, dgated, datt=None):
    """int_fused.py::_k1_bwd_kernel (:160-175). ``datt=None`` is a zero
    cotangent for the attention map. -> (dexc f32, datt_x bf16, da_u
    [C,C] in a_u's dtype, da_u_b f32 [C])."""
    att = torch.sigmoid(att_x.float() + _dot(exc, a_u) + a_u_b)
    dgated = dgated.float()
    da = dgated * exc if datt is None else dgated * exc + datt
    dpre = da * att * (1.0 - att)
    dexc = dgated * att + _dot_t(dpre, a_u)
    return (dexc, dpre.to(_BF16), _wgrad(exc, dpre, a_u.dtype), dpre.sum(dim=0))


def k2_inhibition_bwd_plain(conv_i, mean0, rstd0, scale0, bias0, inp, gi_x, inh,
                            i_u, i_u_b, alpha, mu, dnew):
    """int_fused.py::_k2_bwd_kernel (:254-297). One gradient per forward
    input, in the forward's order: conv_i, inp, gi_x bf16; inh f32; i_u in
    its own dtype; the vectors f32 [C]."""
    cm = conv_i.float() - mean0
    xn = cm * rstd0
    bn0 = xn * scale0 + bias0
    lin = alpha * inh + mu
    t1 = bn0 * lin
    pre2 = inp.float() - _sp(t1)
    inh_hat = _sp(pre2)
    g = torch.sigmoid(gi_x.float() + _dot(inh, i_u) + i_u_b)

    dgpre = dnew * (inh_hat - inh) * g * (1.0 - g)
    dpre2 = dnew * g * torch.sigmoid(pre2)
    dt1 = -dpre2 * torch.sigmoid(t1)
    dbn0 = dt1 * lin
    dlin = dt1 * bn0
    dxn = dbn0 * scale0
    dinh = dnew * (1.0 - g) + dlin * alpha + _dot_t(dgpre, i_u)
    return ((dxn * rstd0).to(_BF16), (-dxn).sum(dim=0) * rstd0,
            (dxn * cm).sum(dim=0), (dbn0 * xn).sum(dim=0), dbn0.sum(dim=0),
            dpre2.to(_BF16), dgpre.to(_BF16), dinh,
            _wgrad(inh, dgpre, i_u.dtype), dgpre.sum(dim=0),
            (dlin * inh).sum(dim=0), dlin.sum(dim=0))


def k3_excitation_bwd_plain(conv_e, mean1, rstd1, scale1, bias1, new_inh, inh,
                            gated, exc, e_w, e_w_b, e_u, e_u_b, kappa, gamma,
                            dnew):
    """int_fused.py::_k3_bwd_kernel (:388-435). One gradient per forward
    input, in the forward's order; both gate biases get the same sum."""
    cm = conv_e.float() - mean1
    xn = cm * rstd1
    bn1 = xn * scale1 + bias1
    lin = kappa * new_inh + gamma
    t1 = bn1 * lin
    exc_hat = _sp(t1)
    g = torch.sigmoid(_dot(inh, e_w) + e_w_b + _dot(gated.float(), e_u) + e_u_b)

    dgpre = dnew * (exc_hat - exc) * g * (1.0 - g)
    dt1 = dnew * g * torch.sigmoid(t1)
    dbn1 = dt1 * lin
    dlin = dt1 * bn1
    dxn = dbn1 * scale1
    db = dgpre.sum(dim=0)
    return ((dxn * rstd1).to(_BF16), (-dxn).sum(dim=0) * rstd1,
            (dxn * cm).sum(dim=0), (dbn1 * xn).sum(dim=0), dbn1.sum(dim=0),
            dlin * kappa, _dot_t(dgpre, e_w), _dot_t(dgpre, e_u).to(_BF16),
            dnew * (1.0 - g), _wgrad(inh, dgpre, e_w.dtype), db,
            _wgrad(gated, dgpre, e_u.dtype), db, (dlin * new_inh).sum(dim=0),
            dlin.sum(dim=0))


# -------------------------------- wrappers ----------------------------------

# Each wrapper's arguments as (name, dtype, shape): 'rows' is [R, C], 'mat'
# [C, C] and 'vec' [C]; every one contiguous and on the device of the first.
_K1_SPEC = (("exc", _F32, "rows"), ("att_x", _BF16, "rows"),
            ("a_u", _BF16, "mat"), ("a_u_b", _F32, "vec"))
_K2_SPEC = (("conv_i", _BF16, "rows"), ("mean0", _F32, "vec"),
            ("rstd0", _F32, "vec"), ("scale0", _F32, "vec"),
            ("bias0", _F32, "vec"), ("inp", _BF16, "rows"),
            ("gi_x", _BF16, "rows"), ("inh", _F32, "rows"),
            ("i_u", _BF16, "mat"), ("i_u_b", _F32, "vec"),
            ("alpha", _F32, "vec"), ("mu", _F32, "vec"))
_K3_SPEC = (("conv_e", _BF16, "rows"), ("mean1", _F32, "vec"),
            ("rstd1", _F32, "vec"), ("scale1", _F32, "vec"),
            ("bias1", _F32, "vec"), ("new_inh", _F32, "rows"),
            ("inh", _F32, "rows"), ("gated", _BF16, "rows"),
            ("exc", _F32, "rows"), ("e_w", _BF16, "mat"),
            ("e_w_b", _F32, "vec"), ("e_u", _BF16, "mat"),
            ("e_u_b", _F32, "vec"), ("kappa", _F32, "vec"),
            ("gamma", _F32, "vec"))


def _reject(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype or t.shape != shape:
        raise ValueError(f"{name}: expected {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    raise ValueError(f"{name}: on {t.device}, expected {device}")


def _on_card(spec, args) -> bool:
    """Check ``args`` against ``spec`` and raise on anything the kernel does
    not take. True: CUDA tensors, launch the kernel. False: CPU tensors,
    take the plain version."""
    first = args[0]
    rows = first.shape[0] if isinstance(first, torch.Tensor) and first.dim() else 0
    if rows <= 0:
        raise ValueError(f"{spec[0][0]}: expected [rows > 0, {C}]")
    device = first.device
    shapes = {"rows": (rows, C), "mat": (C, C), "vec": (C,)}
    for (name, dtype, kind), t in zip(spec, args):
        if not (isinstance(t, torch.Tensor) and t.dtype == dtype
                and t.shape == shapes[kind] and t.is_contiguous()
                and t.device == device):
            _reject(name, t, dtype, shapes[kind], device)
    if device.type == "cuda":
        if device.index != torch.cuda.current_device():
            raise ValueError(f"tensors on {device}, but the current CUDA "
                             f"device is {torch.cuda.current_device()}")
        return True
    if device.type != "cpu":
        raise ValueError(f"no fused-cell implementation for {device}")
    return False


def _launch(lib, fn, tensors):
    stream = torch.cuda.current_stream().cuda_stream
    _native.launch(lib, fn, tensors, tensors[0].shape[0], stream)


def _differentiable(args) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in args)


# Forward launches, after the wrapper's checks.

def _k1_launch(args):
    gated = torch.empty_like(args[0], dtype=_BF16)
    att = torch.empty_like(args[0])
    _launch("int_cell", "k1_attention_fwd", args + (gated, att))
    k1_attention.launches += 1
    return gated, att


def _k2_launch(args):
    out = torch.empty_like(args[7])
    _launch("int_cell", "k2_inhibition_fwd", args + (out,))
    k2_inhibition.launches += 1
    return out


def _k3_launch(args):
    out = torch.empty_like(args[8])
    _launch("int_cell", "k3_excitation_fwd", args + (out,))
    k3_excitation.launches += 1
    return out


def _partials(fn, ref, n):
    """The f32 workspace [blocks, n, C] for ``fn``'s per-block partial sums,
    which the launch itself sums over the blocks."""
    blocks = _native.blocks("int_cell_bwd", fn, ref.shape[0])
    return torch.empty((blocks, n, C), dtype=_F32, device=ref.device)


# ---------------------------- backward wrappers -----------------------------

def k1_attention_bwd(exc, att_x, a_u, a_u_b, dgated, datt=None):
    """The K1 inputs, dgated [R,C] bf16 and datt [R,C] f32 or None (no
    cotangent for the attention map: its read is skipped) -> (dexc [R,C]
    f32, datt_x [R,C] bf16, da_u [C,C] bf16, da_u_b [C] f32)."""
    args = (exc, att_x, a_u, a_u_b, dgated)
    spec = _K1_SPEC + (("dgated", _BF16, "rows"),)
    if datt is not None:
        args, spec = args + (datt,), spec + (("datt", _F32, "rows"),)
    if not _on_card(spec, args):
        return k1_attention_bwd_plain(exc, att_x, a_u, a_u_b, dgated, datt)
    dexc = torch.empty_like(exc)
    dattx = torch.empty_like(att_x)
    da_u, da_u_b = torch.empty_like(a_u), torch.empty_like(a_u_b)
    ws = _partials("k1_attention_bwd", exc, C + 1)
    _launch("int_cell_bwd", "k1_attention_bwd",
            (exc, att_x, a_u, a_u_b, dgated, datt, dexc, dattx, da_u, da_u_b, ws))
    k1_attention_bwd.launches += 1
    return dexc, dattx, da_u, da_u_b


def k2_inhibition_bwd(conv_i, mean0, rstd0, scale0, bias0, inp, gi_x, inh,
                      i_u, i_u_b, alpha, mu, dnew):
    """The K2 inputs and dnew [R,C] f32 -> one gradient per input, in the
    inputs' order and dtypes (the vectors' as f32 [C])."""
    args = (conv_i, mean0, rstd0, scale0, bias0, inp, gi_x, inh, i_u, i_u_b,
            alpha, mu, dnew)
    if not _on_card(_K2_SPEC + (("dnew", _F32, "rows"),), args):
        return k2_inhibition_bwd_plain(*args)
    dconv, dinp, dgix = (torch.empty_like(conv_i) for _ in range(3))
    dinh = torch.empty_like(inh)
    di_u = torch.empty_like(i_u)
    # rows of red: [di_u_b, dalpha, dmu, dmean, drstd, dscale, dbias]
    red = torch.empty((7, C), dtype=_F32, device=inh.device)
    ws = _partials("k2_inhibition_bwd", inh, C + 7)
    _launch("int_cell_bwd", "k2_inhibition_bwd",
            args + (dconv, dinp, dgix, dinh, di_u, red, ws))
    k2_inhibition_bwd.launches += 1
    return (dconv, red[3], red[4], red[5], red[6], dinp, dgix, dinh,
            di_u, red[0], red[1], red[2])


def k3_excitation_bwd(conv_e, mean1, rstd1, scale1, bias1, new_inh, inh, gated,
                      exc, e_w, e_w_b, e_u, e_u_b, kappa, gamma, dnew):
    """The K3 inputs and dnew [R,C] f32 -> one gradient per input, in the
    inputs' order and dtypes; both gate biases get the same sum."""
    args = (conv_e, mean1, rstd1, scale1, bias1, new_inh, inh, gated, exc,
            e_w, e_w_b, e_u, e_u_b, kappa, gamma, dnew)
    if not _on_card(_K3_SPEC + (("dnew", _F32, "rows"),), args):
        return k3_excitation_bwd_plain(*args)
    dconv, dgated = torch.empty_like(conv_e), torch.empty_like(gated)
    dninh, dinh, dexc = (torch.empty_like(exc) for _ in range(3))
    de_w, de_u = torch.empty_like(e_w), torch.empty_like(e_u)
    # rows of red: [de_w_b = de_u_b, dkappa, dgamma, dmean, drstd, dscale, dbias]
    red = torch.empty((7, C), dtype=_F32, device=exc.device)
    ws = _partials("k3_excitation_bwd", exc, 2 * C + 7)
    _launch("int_cell_bwd", "k3_excitation_bwd",
            args + (dconv, dninh, dinh, dgated, dexc, de_w, de_u, red, ws))
    k3_excitation_bwd.launches += 1
    return (dconv, red[3], red[4], red[5], red[6], dninh, dinh, dgated, dexc,
            de_w, red[0], de_u, red[0], red[1], red[2])


# ------------------- differentiable phases (autograd glue) ------------------

def _cotangent(d, like):
    """A cotangent as the backward wrappers take it: contiguous, or zeros
    where autograd passed None for an output nothing read."""
    return torch.zeros_like(like) if d is None else d.contiguous()


def _needed(ctx, grads):
    return tuple(g if need else None
                 for g, need in zip(grads, ctx.needs_input_grad))


# ------------------- the forward phases as custom ops ------------------------

def _k1_impl(exc: Tensor, att_x: Tensor, a_u: Tensor, a_u_b: Tensor) -> tuple[Tensor, Tensor]:
    args = (exc, att_x, a_u, a_u_b)
    return _k1_launch(args) if _on_card(_K1_SPEC, args) else k1_attention_plain(*args)


def _k2_impl(conv_i: Tensor, mean0: Tensor, rstd0: Tensor, scale0: Tensor,
             bias0: Tensor, inp: Tensor, gi_x: Tensor, inh: Tensor, i_u: Tensor,
             i_u_b: Tensor, alpha: Tensor, mu: Tensor) -> Tensor:
    args = (conv_i, mean0, rstd0, scale0, bias0, inp, gi_x, inh, i_u, i_u_b, alpha, mu)
    return _k2_launch(args) if _on_card(_K2_SPEC, args) else k2_inhibition_plain(*args)


def _k3_impl(conv_e: Tensor, mean1: Tensor, rstd1: Tensor, scale1: Tensor,
             bias1: Tensor, new_inh: Tensor, inh: Tensor, gated: Tensor, exc: Tensor,
             e_w: Tensor, e_w_b: Tensor, e_u: Tensor, e_u_b: Tensor, kappa: Tensor,
             gamma: Tensor) -> Tensor:
    args = (conv_e, mean1, rstd1, scale1, bias1, new_inh, inh, gated, exc, e_w, e_w_b,
            e_u, e_u_b, kappa, gamma)
    return _k3_launch(args) if _on_card(_K3_SPEC, args) else k3_excitation_plain(*args)


_k1_op = torch.library.custom_op("pathtracker::k1_attention", _k1_impl, mutates_args=())
_k2_op = torch.library.custom_op("pathtracker::k2_inhibition", _k2_impl, mutates_args=())
_k3_op = torch.library.custom_op("pathtracker::k3_excitation", _k3_impl, mutates_args=())


@_k1_op.register_fake
def _(exc, att_x, a_u, a_u_b):
    return torch.empty_like(exc, dtype=_BF16), torch.empty_like(exc)


@_k2_op.register_fake
def _(conv_i, mean0, rstd0, scale0, bias0, inp, gi_x, inh, i_u, i_u_b, alpha, mu):
    return torch.empty_like(inh)


@_k3_op.register_fake
def _(conv_e, mean1, rstd1, scale1, bias1, new_inh, inh, gated, exc, e_w, e_w_b,
      e_u, e_u_b, kappa, gamma):
    return torch.empty_like(exc)


def _forward(op, impl, args):
    """The op where a program is being traced (a tracer's flag, or its fake
    or functional tensor subclass in place of the activation), else its
    implementation."""
    if (torch.compiler.is_compiling() or torch.compiler.is_exporting()
            or type(args[0]) is not torch.Tensor):
        return op(*args)
    return impl(*args)


class K1Attention(torch.autograd.Function):
    """``k1_attention`` with ``k1_attention_bwd`` as its backward."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        ctx.set_materialize_grads(False)
        return _forward(_k1_op, _k1_impl, args)

    @staticmethod
    @once_differentiable
    def backward(ctx, dgated, datt):
        args = ctx.saved_tensors
        dgated = _cotangent(dgated, args[1])
        datt = None if datt is None else datt.contiguous()
        return _needed(ctx, k1_attention_bwd(*args, dgated, datt))


class K2Inhibition(torch.autograd.Function):
    """``k2_inhibition`` with ``k2_inhibition_bwd`` as its backward."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        ctx.set_materialize_grads(False)
        return _forward(_k2_op, _k2_impl, args)

    @staticmethod
    @once_differentiable
    def backward(ctx, dnew):
        args = ctx.saved_tensors
        return _needed(ctx, k2_inhibition_bwd(*args, _cotangent(dnew, args[7])))


class K3Excitation(torch.autograd.Function):
    """``k3_excitation`` with ``k3_excitation_bwd`` as its backward."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        ctx.set_materialize_grads(False)
        return _forward(_k3_op, _k3_impl, args)

    @staticmethod
    @once_differentiable
    def backward(ctx, dnew):
        args = ctx.saved_tensors
        return _needed(ctx, k3_excitation_bwd(*args, _cotangent(dnew, args[8])))


def k1_attention(exc, att_x, a_u, a_u_b):
    """exc [R,C] f32, att_x [R,C] bf16, a_u [C,C] bf16, a_u_b [C] f32 ->
    (gated_exc [R,C] bf16, att [R,C] f32)."""
    args = (exc, att_x, a_u, a_u_b)
    if _differentiable(args):
        return K1Attention.apply(*args)
    return _forward(_k1_op, _k1_impl, args)


def k2_inhibition(conv_i, mean0, rstd0, scale0, bias0, inp, gi_x, inh,
                  i_u, i_u_b, alpha, mu):
    """conv_i, inp, gi_x [R,C] bf16; inh [R,C] f32; i_u [C,C] bf16; the
    rest [C] f32 -> new_inh [R,C] f32."""
    args = (conv_i, mean0, rstd0, scale0, bias0, inp, gi_x, inh, i_u, i_u_b,
            alpha, mu)
    if _differentiable(args):
        return K2Inhibition.apply(*args)
    return _forward(_k2_op, _k2_impl, args)


def k3_excitation(conv_e, mean1, rstd1, scale1, bias1, new_inh, inh, gated,
                  exc, e_w, e_w_b, e_u, e_u_b, kappa, gamma):
    """conv_e, gated [R,C] bf16; new_inh, inh, exc [R,C] f32; e_w, e_u
    [C,C] bf16; the rest [C] f32 -> new_exc [R,C] f32."""
    args = (conv_e, mean1, rstd1, scale1, bias1, new_inh, inh, gated, exc,
            e_w, e_w_b, e_u, e_u_b, kappa, gamma)
    if _differentiable(args):
        return K3Excitation.apply(*args)
    return _forward(_k3_op, _k3_impl, args)


FORWARD_KERNELS = (k1_attention, k2_inhibition, k3_excitation)
BACKWARD_KERNELS = (k1_attention_bwd, k2_inhibition_bwd, k3_excitation_bwd)
KERNELS = FORWARD_KERNELS + BACKWARD_KERNELS
for _k in KERNELS:
    _k.launches = 0
