"""Gradients of the port's InT against ``jax.grad`` of pathtracker_tpu's, on
the same inputs and the same weights, for every parameter.

Loss: sum(logit^2), as tests/test_int_fused.py uses. Weights go JAX -> port
with ``export_reference_state_dict`` and gradients come back with
``to_jax_params``. Each gradient is normalised by its largest entry (at
least 1e-3) before it is compared:
  * f32 (the eager cell; shapes of tests/test_int_parity.py): atol 1e-3.
    The forward of the two frameworks drifts ~3e-4 through the T=5
    recurrence (tests/test_torch_int_eager.py) and the backward carries that
    on; an equation error moves a gradient by O(0.1);
  * mixed bf16, eager and fused (shapes of tests/test_int_fused.py): atol
    6e-3, the bound that file holds the JAX fused cell to — the paths round
    their bf16 cotangents at different points, so isolated elements differ
    by one bf16 ulp of the largest summand. The fused case runs the Pallas
    kernels, forward and backward, in interpret mode.
A parameter the forward never reads (``w``, and more in a lesioned config)
has a zero gradient in JAX and none in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracker_torch.models.int_circuit import InT as TInT
from pathtracker_torch.train.torch_import import (export_reference_state_dict,
                                                  to_jax_params)
from pathtracker_tpu.models.int_circuit import InT as JInT
from torch_threads import one_thread  # noqa: F401

F32_SHAPE = dict(b=3, c=8, t=5, hw=12, k=5)
MIXED_SHAPE = dict(b=4, c=32, t=5, hw=16, k=5)


def _pair(case, shape, seed):
    b, c, t, hw, k = (shape[n] for n in ("b", "c", "t", "hw", "k"))
    x = np.random.default_rng(seed).standard_normal((b, 3, t, hw, hw)).astype(np.float32)
    jm = JInT(dimensions=c, timesteps=t, kernel_size=k, **case)
    params = jm.init(jax.random.key(1), jnp.asarray(x))["params"]
    tm = TInT(dimensions=c, timesteps=t, kernel_size=k, device="cpu", **case)
    tm.load_state_dict(export_reference_state_dict(
        {n: np.asarray(v) for n, v in params.items()}), strict=True)
    return jm, params, tm, x


def _jax_grads(jm, params, x):
    def loss(p):
        logit, _ = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(jnp.square(logit))
    return {n: np.asarray(g) for n, g in jax.grad(loss)(params).items()}


def _torch_grads(tm, x):
    logit, _ = tm(torch.from_numpy(x))
    names, tensors = zip(*tm.named_parameters())
    grads = torch.autograd.grad(logit.square().sum(), tensors, allow_unused=True)
    # No gradient where the forward never reads the parameter (always ``w``;
    # more in the lesioned configs); JAX has exact zeros there.
    assert "unit1.w" in [n for n, g in zip(names, grads) if g is None]
    return to_jax_params({n: torch.zeros_like(p) if g is None else g
                          for n, p, g in zip(names, tensors, grads)})


def _assert_close(ours, theirs, atol):
    assert set(ours) == set(theirs)
    for name, want in theirs.items():
        got = ours[name]
        assert got.shape == want.shape, name
        scale = max(np.abs(want).max(), 1e-3)
        np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("case", [
    {},
    {"use_attention": False},
    {"no_inh": True},
    {"lesion_mu": True, "lesion_kappa": True},
])
def test_f32_gradients_match_jax(case):
    jm, params, tm, x = _pair(case, F32_SHAPE, seed=42)
    assert not tm.use_fused
    _assert_close(_torch_grads(tm, x), _jax_grads(jm, params, x), atol=1e-3)


@pytest.mark.parametrize("fused", [False, True])
def test_mixed_gradients_match_jax(fused):
    jm, params, tm, x = _pair({"dtype": "bfloat16", "fused": fused}, MIXED_SHAPE, seed=0)
    assert tm.use_fused == fused
    _assert_close(_torch_grads(tm, x), _jax_grads(jm, params, x), atol=6e-3)


def test_mixed_fused_gradients_match_mixed_eager():
    """The port's two mixed cells against each other, at the tolerance
    tests/test_int_fused.py holds the JAX package's two to."""
    grads = {}
    for fused in (False, True):
        _, _, tm, x = _pair({"dtype": "bfloat16", "fused": fused}, MIXED_SHAPE, seed=0)
        grads[fused] = _torch_grads(tm, x)
    _assert_close(grads[True], grads[False], atol=6e-3)


@pytest.mark.parametrize("case", [
    {},
    {"dtype": "bfloat16", "fused": False},
    {"no_inh": True, "use_attention": False},
])
def test_remat_gives_identical_gradients(case):
    """Recomputing a step in backward replays the same operations on the same
    values: the gradients are bit-identical with and without it."""
    shape = MIXED_SHAPE if "dtype" in case else F32_SHAPE
    grads = {}
    for remat in (True, False):
        _, _, tm, x = _pair({**case}, shape, seed=3)
        tm.remat = remat
        grads[remat] = _torch_grads(tm, x)
    for name, want in grads[False].items():
        assert np.array_equal(grads[True][name], want), name


def test_input_gradient_and_testmode_flow_through_the_fused_cell():
    """A gradient with respect to the clip (attribution), and cotangents for
    the per-step attention maps, which reach K1's backward as ``datt``."""
    _, _, tm, x = _pair({"dtype": "bfloat16"}, MIXED_SHAPE, seed=5)
    for p in tm.parameters():
        p.requires_grad_(False)
    xt = torch.from_numpy(x).requires_grad_()
    logit, states, gates = tm(xt, testmode=True)
    (dx,) = torch.autograd.grad(logit.sum() + gates.square().mean() + states.mean(), [xt])
    assert dx.shape == xt.shape and torch.isfinite(dx).all() and dx.abs().max() > 0
