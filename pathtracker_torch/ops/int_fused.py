"""The InT cell's three fused elementwise/gate phases, forward halves
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

Each phase has a plain PyTorch version and a wrapper. The wrapper checks
its inputs, then takes the plain version for CPU tensors and launches the
hand-written CUDA kernel (csrc/int_cell.cu) for CUDA tensors, raising if
the launch fails. ``<wrapper>.launches`` counts kernel launches only.
"""

from __future__ import annotations

import torch

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
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    raise NotImplementedError(
        f"{name} requires grad: the fused cell has no backward yet; run the "
        "forward under torch.no_grad()")


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
    grad = torch.is_grad_enabled()
    for (name, dtype, kind), t in zip(spec, args):
        if not (isinstance(t, torch.Tensor) and t.dtype == dtype
                and t.shape == shapes[kind] and t.is_contiguous()
                and t.device == device) or (grad and t.requires_grad):
            _reject(name, t, dtype, shapes[kind], device)
    if device.type == "cuda":
        if device.index != torch.cuda.current_device():
            raise ValueError(f"tensors on {device}, but the current CUDA "
                             f"device is {torch.cuda.current_device()}")
        return True
    if device.type != "cpu":
        raise ValueError(f"no fused-cell implementation for {device}")
    return False


def _launch(fn, tensors):
    stream = torch.cuda.current_stream().cuda_stream
    _native.launch("int_cell", fn, tensors, tensors[0].shape[0], stream)


def k1_attention(exc, att_x, a_u, a_u_b):
    """exc [R,C] f32, att_x [R,C] bf16, a_u [C,C] bf16, a_u_b [C] f32 ->
    (gated_exc [R,C] bf16, att [R,C] f32)."""
    args = (exc, att_x, a_u, a_u_b)
    if not _on_card(_K1_SPEC, args):
        return k1_attention_plain(*args)
    gated = torch.empty_like(exc, dtype=_BF16)
    att = torch.empty_like(exc)
    _launch("k1_attention_fwd", args + (gated, att))
    k1_attention.launches += 1
    return gated, att


def k2_inhibition(conv_i, mean0, rstd0, scale0, bias0, inp, gi_x, inh,
                  i_u, i_u_b, alpha, mu):
    """conv_i, inp, gi_x [R,C] bf16; inh [R,C] f32; i_u [C,C] bf16; the
    rest [C] f32 -> new_inh [R,C] f32."""
    args = (conv_i, mean0, rstd0, scale0, bias0, inp, gi_x, inh, i_u, i_u_b,
            alpha, mu)
    if not _on_card(_K2_SPEC, args):
        return k2_inhibition_plain(*args)
    out = torch.empty_like(inh)
    _launch("k2_inhibition_fwd", args + (out,))
    k2_inhibition.launches += 1
    return out


def k3_excitation(conv_e, mean1, rstd1, scale1, bias1, new_inh, inh, gated,
                  exc, e_w, e_w_b, e_u, e_u_b, kappa, gamma):
    """conv_e, gated [R,C] bf16; new_inh, inh, exc [R,C] f32; e_w, e_u
    [C,C] bf16; the rest [C] f32 -> new_exc [R,C] f32."""
    args = (conv_e, mean1, rstd1, scale1, bias1, new_inh, inh, gated, exc,
            e_w, e_w_b, e_u, e_u_b, kappa, gamma)
    if not _on_card(_K3_SPEC, args):
        return k3_excitation_plain(*args)
    out = torch.empty_like(exc)
    _launch("k3_excitation_fwd", args + (out,))
    k3_excitation.launches += 1
    return out


KERNELS = (k1_attention, k2_inhibition, k3_excitation)
for _k in KERNELS:
    _k.launches = 0
