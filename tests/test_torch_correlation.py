"""pathtracker_torch.ops.correlation against pathtracker_tpu.ops.correlation
on the same seeded inputs: the plain forward against ``correlation_xla`` and
against the Pallas kernel in interpret mode, the two plain backward versions
against autograd of the plain forward and against ``jax.grad`` through the
JAX op, ``l2_normalize``, and what the wrappers refuse.

Tolerances: rtol 1e-5 / atol 1e-6, as tests/test_correlation.py holds the
Pallas kernel to the XLA formulation: f32 sums of at most 8 products taken
in another order. The gradients are sums of up to patch^2 = 225 products of
standard-normal values (entries of magnitude ~15, partial sums larger), taken
in another order: rtol 1e-5 / atol 2e-5 there, where a wrong displacement
moves entries by O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracker_torch.ops import correlation as T
from pathtracker_tpu.ops import correlation as J

# tests/test_correlation.py's cases, plus an odd-sized one.
CASES = {
    "patch5": dict(b=2, h=8, w=8, c=4, seed=0, patch=5, dilation=1),
    "patch15": dict(b=1, h=16, w=16, c=8, seed=1, patch=15, dilation=1),
    "dilated": dict(b=1, h=12, w=12, c=4, seed=2, patch=5, dilation=2),
    "odd": dict(b=2, h=7, w=9, c=3, seed=3, patch=3, dilation=1),
}
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=2e-5)


def _inputs(b, h, w, c, seed, patch, dilation, cotangent=False):
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    f2 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    if cotangent:
        return f1, f2, rng.standard_normal((b, h, w, patch * patch)).astype(np.float32)
    return f1, f2


@pytest.mark.parametrize("case", CASES)
def test_plain_forward_matches_xla(case):
    cfg = CASES[case]
    f1, f2 = _inputs(**cfg)
    want = np.asarray(J.correlation_xla(jnp.asarray(f1), jnp.asarray(f2),
                                        patch=cfg["patch"], dilation=cfg["dilation"]))
    got = T.correlation_plain(torch.from_numpy(f1), torch.from_numpy(f2),
                              cfg["patch"], cfg["dilation"])
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("case", CASES)
def test_wrapper_on_cpu_matches_pallas_interpret(case):
    """The wrapper takes the plain version for CPU tensors and counts no
    launch; the Pallas kernel runs in interpret mode."""
    cfg = CASES[case]
    f1, f2 = _inputs(**cfg)
    want = np.asarray(J.correlation_pallas(jnp.asarray(f1), jnp.asarray(f2),
                                           patch=cfg["patch"], dilation=cfg["dilation"],
                                           interpret=True))
    before = [k.launches for k in T.KERNELS]
    got = T.correlation(torch.from_numpy(f1), torch.from_numpy(f2),
                        cfg["patch"], cfg["dilation"])
    assert [k.launches for k in T.KERNELS] == before
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_autograd_of_plain_forward(case):
    cfg = CASES[case]
    f1, f2, g = (torch.from_numpy(a) for a in _inputs(**cfg, cotangent=True))
    f1.requires_grad_(), f2.requires_grad_()
    out = T.correlation_plain(f1, f2, cfg["patch"], cfg["dilation"])
    want1, want2 = torch.autograd.grad(out, (f1, f2), g)
    got1 = T.correlation_bwd_f1_plain(g, f2.detach(), cfg["patch"], cfg["dilation"])
    got2 = T.correlation_bwd_f2_plain(g, f1.detach(), cfg["patch"], cfg["dilation"])
    assert got1.is_contiguous() and got2.is_contiguous()
    torch.testing.assert_close(got1, want1, **GRAD_TOL)
    torch.testing.assert_close(got2, want2, **GRAD_TOL)


@pytest.mark.parametrize("case", CASES)
def test_gradient_through_wrapper_matches_jax_grad(case):
    """jax.grad through ``correlation`` (its custom VJP) against autograd
    through the port's ``correlation`` (the autograd.Function whose backward
    is the two backward wrappers), for a nonlinear loss."""
    cfg = CASES[case]
    f1, f2 = _inputs(**cfg)
    patch, dilation = cfg["patch"], cfg["dilation"]

    def loss(a, b):
        return jnp.sum(jnp.tanh(J.correlation(a, b, patch, dilation)))

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(f1), jnp.asarray(f2))
    t1 = torch.from_numpy(f1).requires_grad_()
    t2 = torch.from_numpy(f2).requires_grad_()
    out = T.correlation(t1, t2, patch, dilation)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "CorrelationBackward"
    torch.tanh(out).sum().backward()
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(want[0]), **GRAD_TOL)
    np.testing.assert_allclose(t2.grad.numpy(), np.asarray(want[1]), **GRAD_TOL)


def test_gradient_for_one_input_only():
    f1, f2 = (torch.from_numpy(a) for a in _inputs(**CASES["patch5"]))
    f2.requires_grad_()
    T.correlation(f1, f2, 5).square().sum().backward()
    assert f1.grad is None and f2.grad is not None


def test_l2_normalize_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 3, 4, 6)).astype(np.float32)
    x[0, 0, 0] = 0.0  # eps sits inside the square root: 0 / sqrt(1e-6)
    want = np.asarray(J.l2_normalize(jnp.asarray(x)))
    got = T.l2_normalize(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert torch.equal(got[0, 0, 0], torch.zeros(6))


@pytest.mark.parametrize("fn", ["correlation", "correlation_bwd_f1", "correlation_bwd_f2"])
def test_wrappers_refuse_what_the_kernels_do_not_take(fn):
    wrapper = getattr(T, fn)
    f = torch.zeros(1, 4, 4, 3)
    first = f if fn == "correlation" else torch.zeros(1, 4, 4, 9)
    assert wrapper(first, f, 3).shape == (1, 4, 4, 9 if fn == "correlation" else 3)
    with pytest.raises(ValueError, match="float32"):
        wrapper(first.double(), f.double(), 3)
    with pytest.raises(ValueError, match="float32"):
        wrapper(first, f.to(torch.bfloat16), 3)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(first, f.permute(0, 2, 1, 3), 3)
    with pytest.raises(ValueError, match=r"\[N,H,W,C\]"):
        wrapper(first, f[0], 3)
    with pytest.raises(ValueError, match="expected"):
        wrapper(first, torch.zeros(1, 4, 5, 3), 3)
    with pytest.raises(ValueError, match="odd"):
        wrapper(first, f, 4)
    with pytest.raises(ValueError, match="dilation"):
        wrapper(first, f, 3, 0)
    with pytest.raises(TypeError, match="tensor"):
        wrapper(first, f.numpy(), 3)


def test_channel_mismatch_and_cotangent_width_are_refused():
    with pytest.raises(ValueError, match="expected"):
        T.correlation(torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 2), 3)
    with pytest.raises(ValueError, match="expected"):
        T.correlation_bwd_f1(torch.zeros(1, 4, 4, 25), torch.zeros(1, 4, 4, 3), 3)
