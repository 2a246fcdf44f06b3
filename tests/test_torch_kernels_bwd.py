"""The fused InT cell phases' backward halves: the plain versions of
pathtracker_torch.ops.int_fused against the Pallas backward kernels of
pathtracker_tpu.ops.int_fused, run through ``jax.vjp`` in interpret mode on
the CPU; and the port's ``autograd.Function``s against the plain versions.

The JAX kernels take the packed [R*C/128, 128] view, block-diagonal gate
matrices and lane-tiled vectors, so their gradients come back packed too:
a row gradient compares after a reshape; a [128, 128] weight gradient folds
to the sum of its four diagonal [32, 32] blocks; a [1, 128] vector gradient
to the sum of its four lane groups.

Tolerances (cotangents are O(1); ``scale`` is the output's largest entry, at
least 1):
  * row gradients: the two frameworks' sigmoid and softplus differ by f32
    ulps, and the transposed products take their cotangent ROUNDED to bf16,
    so now and then one operand lands on the other side of a rounding
    boundary and moves by a bf16 ulp. Every element within 2^-8 * scale; all
    but one in a thousand within 1e-5 * scale (f32) or one bf16 ulp (bf16);
  * per-channel sums: 1e-4 * scale (f32 sums of 1024 terms, other order);
  * weight gradients: 2^-7 * scale. The Pallas kernels round each of the
    four block-diagonal copies' partial sums to bf16 and then add them; the
    port has one block and rounds once, so they differ by up to a bf16 ulp
    of the largest entry;
  * the conv output's gradient of K2 and K3 (the batch norm's direct input
    cotangent): the port's is f32, unrounded, where Pallas rounds it to
    bf16; the port's rounded to bf16 is held to Pallas's as a bf16 row
    gradient, and within one bf16 ulp of it on every element
    (``test_k2_k3_conv_gradient_is_pallas_unrounded``).

The CUDA kernels themselves are held against the plain versions on the card
by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracker_torch.ops import int_fused as T
from pathtracker_tpu.ops import int_fused as J
from test_torch_kernels import (BF16, C, K1_ARGS, K2_ARGS, K3_ARGS, _inputs,
                                _jax, _torch)

ROWS = 1024
_BF16_ROW_GRADS = {"att_x", "inp", "gi_x", "gated"}
_F32_CONV_GRADS = {"conv_i", "conv_e"}  # f32 in the port, bf16 in Pallas
_MATS = {"a_u", "i_u", "e_w", "e_u"}


def _cotangent(seed, dtype=np.float32):
    x = np.random.default_rng(seed).standard_normal((ROWS, C)).astype(np.float32)
    if dtype == "bf16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x


def _fold(name, grad):
    """A packed JAX gradient -> the port's layout, f32 numpy."""
    g = np.asarray(jnp.asarray(grad, jnp.float32))
    if name in _MATS:
        return sum(g[i * C:(i + 1) * C, i * C:(i + 1) * C] for i in range(4))
    if g.shape[0] == 1:
        return g.reshape(4, C).sum(axis=0)
    return g.reshape(-1, C)


def _check(names, ours, theirs):
    assert len(ours) == len(theirs) == len(names)
    for name, a, b in zip(names, ours, theirs):
        want = _fold(name, b)
        got = a.float().numpy()
        assert got.shape == want.shape, name
        diff = np.abs(got - want)
        scale = max(np.abs(want).max(), 1.0)
        if name in _MATS:
            assert a.dtype == BF16, name
            assert diff.max() <= 2.0 ** -7 * scale, (name, diff.max(), scale)
        elif want.ndim == 1:
            assert a.dtype == torch.float32, name
            assert diff.max() <= 1e-4 * scale, (name, diff.max(), scale)
        else:
            bf16 = name in _BF16_ROW_GRADS | _F32_CONV_GRADS
            assert a.dtype == (BF16 if name in _BF16_ROW_GRADS else torch.float32), name
            if name in _F32_CONV_GRADS:
                got = a.to(BF16).float().numpy()
                diff = np.abs(got - want)
            if bf16:
                tight = np.spacing(np.maximum(np.abs(got), np.abs(want))) * 2.0 ** 16
            else:
                tight = np.full_like(diff, 1e-5 * scale)
            assert np.all(diff <= np.maximum(tight, 2.0 ** -8 * scale)), (name, diff.max())
            assert np.mean(diff > tight) <= 1e-3, (name, np.mean(diff > tight))


@pytest.mark.parametrize("with_datt", [True, False])
def test_k1_bwd_plain_matches_pallas(with_datt):
    d = _inputs(ROWS, seed=10)
    t, j = _torch(d), _jax(d)
    dgated, datt = _cotangent(11, "bf16"), _cotangent(12)
    _, vjp = jax.vjp(J.k1_attention, *(j[k] for k in K1_ARGS))
    theirs = vjp((J.pack(jnp.asarray(dgated, jnp.bfloat16)),
                  J.pack(jnp.asarray(datt if with_datt else np.zeros_like(datt)))))
    ours = T.k1_attention_bwd_plain(
        *(t[k] for k in K1_ARGS), torch.tensor(dgated).to(BF16),
        torch.tensor(datt) if with_datt else None)
    _check(K1_ARGS, ours, theirs)


def test_k2_bwd_plain_matches_pallas():
    d = _inputs(ROWS, seed=13)
    t, j = _torch(d), _jax(d)
    dnew = _cotangent(14)
    _, vjp = jax.vjp(J.k2_inhibition, *(j[k] for k in K2_ARGS))
    theirs = vjp(J.pack(jnp.asarray(dnew)))
    ours = T.k2_inhibition_bwd_plain(*(t[k] for k in K2_ARGS), torch.tensor(dnew))
    _check(K2_ARGS, ours, theirs)


def test_k3_bwd_plain_matches_pallas():
    d = _inputs(ROWS, seed=15)
    t, j = _torch(d), _jax(d)
    dnew = _cotangent(16)
    _, vjp = jax.vjp(J.k3_excitation, *(j[k] for k in K3_ARGS))
    theirs = vjp(J.pack(jnp.asarray(dnew)))
    ours = T.k3_excitation_bwd_plain(*(t[k] for k in K3_ARGS), torch.tensor(dnew))
    _check(K3_ARGS, ours, theirs)


@pytest.mark.parametrize("phase", ["k2", "k3"])
def test_k2_k3_conv_gradient_is_pallas_unrounded(phase):
    """K2's and K3's gradient for the conv output is the Pallas kernels'
    before their rounding: f32 here, and rounded to bf16 within one bf16 ulp
    of Pallas's on every element; the seven per-channel sums beside it
    (K2: di_u_b, dalpha, dmu and the batch norm's four; K3: the gate
    biases', dkappa, dgamma and the batch norm's four) as ``_check`` holds
    them."""
    names, jfn, plain, seeds = {
        "k2": (K2_ARGS, J.k2_inhibition, T.k2_inhibition_bwd_plain, (13, 14)),
        "k3": (K3_ARGS, J.k3_excitation, T.k3_excitation_bwd_plain, (15, 16))}[phase]
    d = _inputs(ROWS, seed=seeds[0])
    t, j = _torch(d), _jax(d)
    dnew = _cotangent(seeds[1])
    _, vjp = jax.vjp(jfn, *(j[k] for k in names))
    theirs = vjp(J.pack(jnp.asarray(dnew)))
    ours = plain(*(t[k] for k in names), torch.tensor(dnew))
    assert ours[0].dtype == torch.float32
    want = _fold(names[0], theirs[0])
    got = ours[0].to(BF16).float().numpy()
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)).astype(np.float32)) * 2.0 ** 16
    assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()
    vectors = [i for i, g in enumerate(ours) if g.dim() == 1]
    assert len(vectors) == (8 if phase == "k3" else 7)  # K3's gate biases share a sum
    _check([names[i] for i in vectors], [ours[i] for i in vectors],
           [theirs[i] for i in vectors])


def _leaves(t, names):
    return [t[k].clone().requires_grad_() for k in names]


@pytest.mark.parametrize("use", ["both", "gated", "att"])
def test_k1_function_backward_is_the_plain_backward(use):
    """The differentiable wrapper on CPU tensors: autograd hands the outputs'
    cotangents to ``k1_attention_bwd``, None for an output nothing read."""
    t = _torch(_inputs(100, seed=20))  # a ragged row count
    args = _leaves(t, K1_ARGS)
    dgated = torch.tensor(_cotangent(21, "bf16")[:100]).to(BF16)
    datt = torch.tensor(_cotangent(22)[:100])
    before = T.k1_attention_bwd.launches
    gated, att = T.k1_attention(*args)
    outs, cots = {"both": ((gated, att), (dgated, datt)),
                  "gated": ((gated,), (dgated,)),
                  "att": ((att,), (datt,))}[use]
    got = torch.autograd.grad(outs, args, cots)
    want = T.k1_attention_bwd_plain(
        *(a.detach() for a in args),
        dgated if use != "att" else torch.zeros_like(dgated),
        datt if use != "gated" else None)
    for name, a, b in zip(K1_ARGS, got, want):
        assert torch.equal(a, b), name
    assert T.k1_attention_bwd.launches == before  # the plain version is no launch


@pytest.mark.parametrize("wrapper,plain_bwd,names", [
    (T.k2_inhibition, T.k2_inhibition_bwd_plain, K2_ARGS),
    (T.k3_excitation, T.k3_excitation_bwd_plain, K3_ARGS),
])
def test_function_backward_is_the_plain_backward(wrapper, plain_bwd, names):
    """Every input's gradient is the plain backward's. The conv output's f32
    gradient goes to its f32 view ``conv_f32`` (the view's backward then
    rounds it to the bf16 conv output), and a conv output that needs a
    gradient without a view that takes one is refused."""
    t = _torch(_inputs(100, seed=23))
    args = _leaves(t, names)
    dnew = torch.tensor(_cotangent(24)[:100])
    want = plain_bwd(*(a.detach() for a in args), dnew)
    assert want[0].dtype == torch.float32
    view = args[0].float()
    dview, *got = torch.autograd.grad(wrapper(*args, conv_f32=view), [view, *args], dnew)
    assert torch.equal(dview, want[0])
    assert torch.equal(got[0], want[0].to(BF16))
    for name, a, b in zip(names[1:], got[1:], want[1:]):
        assert a.dtype == t[name].dtype and torch.equal(a, b), name
    for no_view in ({}, {"conv_f32": view.detach()}):
        with pytest.raises(ValueError, match="f32 view"):
            wrapper(*args, **no_view)


def test_only_needed_gradients_come_back():
    """An input that needs no gradient gets None, and the forward under
    ``no_grad`` builds no graph."""
    t = _torch(_inputs(64, seed=25))
    args = [t[k] for k in K2_ARGS]
    args[7] = args[7].clone().requires_grad_()  # inh only
    out = T.k2_inhibition(*args)
    (dinh,) = torch.autograd.grad(out, [args[7]], torch.ones_like(out))
    want = T.k2_inhibition_bwd_plain(*(a.detach() for a in args), torch.ones_like(out))
    assert torch.equal(dinh, want[7])
    with torch.no_grad():
        assert not T.k2_inhibition(*args).requires_grad


@pytest.mark.parametrize("wrapper,names,extra", [
    (T.k1_attention_bwd, K1_ARGS, ("dgated",)),
    (T.k2_inhibition_bwd, K2_ARGS, ("dnew",)),
    (T.k3_excitation_bwd, K3_ARGS, ("dnew",)),
])
def test_backward_wrapper_checks_its_cotangent(wrapper, names, extra):
    t = _torch(_inputs(64, seed=26))
    args = [t[k] for k in names]
    good = torch.zeros(64, C, dtype=BF16 if extra == ("dgated",) else torch.float32)
    assert len(wrapper(*args, good)) == len(names)
    with pytest.raises(ValueError, match=extra[0]):
        wrapper(*args, good.double())
    with pytest.raises(ValueError, match=extra[0]):
        wrapper(*args, good[:32])
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(*args, torch.cat([good, good], dim=1)[:, ::2])

