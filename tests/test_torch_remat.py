"""The eager InT cell's remat policies (pathtracker_torch/models/int_circuit.py)
against each other and against the JAX package's InT(remat_policy=...).

A policy changes what a step keeps for its backward, never what backward
computes: the port's loss and gradients under 'full', 'conv', 'conv_gates'
and remat=False are held bit-identical, f32 and mixed eager (JAX's own bound
is loss 1e-6, gradients atol 1e-5 / rtol 1e-4, tests/test_int_parity.py:
189-217). Against JAX at tests/test_int_parity.py:18's widths and one step
(T=1), at that file's one-step parity tolerance (atol 1e-4, :120-129): the
loss, and each gradient normalised by its largest entry (at least 1e-3).
And no policy is a no-op: counted in backward, 'full' replays both convs of
every step, 'conv' none, and 'conv_gates' no gate matmul either."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pathtracker_torch.models.int_circuit import InT as TInT
from pathtracker_torch.train.torch_import import (export_reference_state_dict,
                                                  to_jax_params)
from pathtracker_tpu.models.int_circuit import InT as JInT

B, C, T, HW, K = 3, 8, 5, 12, 5
POLICIES = ("full", "conv", "conv_gates")


def _x(t, seed=13):
    return np.random.default_rng(seed).standard_normal((B, 3, t, HW, HW)).astype(np.float32)


def _loss_and_grads(model, x):
    """BCE against alternating labels, as tests/test_int_parity.py's remat
    test; gradients for every parameter and the clip."""
    xt = torch.from_numpy(x).requires_grad_()
    logit = model(xt)[0][:, 0]
    y = torch.from_numpy((np.arange(B) % 2).astype(np.float32))
    loss = (logit.clamp_min(0) - logit * y + torch.log1p(torch.exp(-logit.abs()))).mean()
    names, tensors = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, [*tensors, xt], allow_unused=True)
    out = {n: torch.zeros_like(p) if g is None else g
           for n, p, g in zip(names, tensors, grads)}
    return loss.detach(), out, grads[-1]


class _Ops(TorchDispatchMode):
    """Counts the aten calls that run while it is active."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[func] = self.calls.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", [{}, {"dtype": "bfloat16", "fused": False},
                                  {"no_inh": True, "use_attention": False}],
                         ids=["f32", "mixed-eager", "no_inh-no_attention"])
def test_policies_give_bit_identical_loss_and_gradients(case):
    x, runs = _x(T), {}
    for policy, remat in [(p, True) for p in POLICIES] + [("conv", False)]:
        model = TInT(dimensions=C, timesteps=T, kernel_size=K, device="cpu",
                     remat=remat, remat_policy=policy, **case)
        assert not model.use_fused
        runs[policy if remat else "none"] = _loss_and_grads(model, x)
    loss, grads, dx = runs.pop("none")
    for policy, (l2, g2, dx2) in runs.items():
        assert torch.equal(l2, loss), policy
        assert torch.equal(dx2, dx), policy
        for name, want in grads.items():
            assert torch.equal(g2[name], want), (policy, name)


def test_policies_are_not_no_ops():
    """Ops run in backward at T=5: 'full' replays the 2T convs and the 4T
    gate matmuls, 'conv' only the matmuls, 'conv_gates' neither; their
    backward's other ops are the same."""
    conv, mm = torch.ops.aten.convolution.default, torch.ops.aten.mm.default
    x, counts = torch.from_numpy(_x(T)), {}
    for policy, remat in [(p, True) for p in POLICIES] + [("conv", False)]:
        model = TInT(dimensions=C, timesteps=T, kernel_size=K, device="cpu",
                     remat=remat, remat_policy=policy)
        loss = model(x)[0].square().sum()
        with _Ops() as ops:
            loss.backward()
        counts[policy if remat else "none"] = ops.calls
    none = counts["none"]
    assert counts["full"][conv] - none.get(conv, 0) == 2 * T
    assert counts["conv"].get(conv, 0) == none.get(conv, 0)
    assert counts["conv_gates"].get(conv, 0) == none.get(conv, 0)
    assert counts["full"][mm] - none[mm] == counts["conv"][mm] - none[mm] == 4 * T
    assert counts["conv_gates"][mm] == none[mm]


def test_fused_cell_ignores_the_policy():
    x, grads = _x(T), {}
    for policy in ("full", "conv"):
        model = TInT(dimensions=32, timesteps=T, kernel_size=K, dtype="bfloat16",
                     device="cpu", remat_policy=policy)
        assert model.use_fused
        grads[policy] = _loss_and_grads(model, x)[1]
    for name, want in grads["full"].items():
        assert torch.equal(grads["conv"][name], want), name


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        TInT(dimensions=C, timesteps=T, kernel_size=K, device="cpu", remat_policy="dots")


@pytest.mark.parametrize("policy", POLICIES)
def test_each_policy_matches_jax_at_one_step(policy):
    x = _x(1, seed=7)
    jm = JInT(dimensions=C, timesteps=1, kernel_size=K, remat_policy=policy)
    params = jm.init(jax.random.key(21), jnp.asarray(x))["params"]
    y = jnp.asarray((np.arange(B) % 2).astype(np.float32))

    def loss(p):
        logit = jm.apply({"params": p}, jnp.asarray(x))[0][:, 0]
        return jnp.mean(jnp.maximum(logit, 0) - logit * y
                        + jnp.log1p(jnp.exp(-jnp.abs(logit))))

    want_loss, want = jax.value_and_grad(loss)(params)
    tm = TInT(dimensions=C, timesteps=1, kernel_size=K, device="cpu", remat_policy=policy)
    tm.load_state_dict(export_reference_state_dict(
        {n: np.asarray(v) for n, v in params.items()}), strict=True)
    got_loss, got, _ = _loss_and_grads(tm, x)
    assert abs(float(got_loss) - float(want_loss)) <= 1e-4
    ours = to_jax_params(got)
    assert set(ours) == set(want)
    for name, w in want.items():
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-3)
        np.testing.assert_allclose(ours[name] / scale, w / scale, rtol=0, atol=1e-4,
                                   err_msg=name)
