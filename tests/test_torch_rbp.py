"""The port's Neumann RBP and Jacobian penalty against pathtracker_tpu's
(ops/rbp.py, ops/penalty.py), and InT with ``grad_method='rbp'``.

The number of Neumann terms a JAX backward takes is read from JAX's own
loop, run eagerly (``jax.disable_jit``) with a counting ``vjp_state``: k
calls are k terms when the sum of all k equals the returned gradient
(the cap), else the last call was the one the exit rule discarded.

Tolerances: on the toy steps, f32 sums of a few products in another order:
rtol 1e-5 / atol 1e-6. InT at f32 (B=3, C=8, T=4, H=W=12, K=5): each
gradient normalised by its largest entry to atol 1e-3, the bound
tests/test_torch_int_grad.py holds BPTT gradients to, and the forward to
atol 1e-3 / rtol 5e-3 (tests/test_int_parity.py:93); the port's RBP forward
against its own BPTT forward exactly (the same operations, as
tests/test_rbp.py:101-131 holds JAX's two), and against JAX's at the
forward tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracker_torch.models.int_circuit import InT as TInT
from pathtracker_torch.ops import penalty as tpenalty
from pathtracker_torch.ops import rbp as trbp
from pathtracker_torch.train.torch_import import state_dict_from_jax, to_jax_params
from pathtracker_tpu.ops import penalty as jpenalty
from pathtracker_tpu.ops import rbp as jrbp

TOL = dict(rtol=1e-5, atol=1e-6)
N = 5


def _toy(seed, scale):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((N, N)) * scale).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    s = rng.standard_normal((2, N)).astype(np.float32)
    c = rng.standard_normal((2, N)).astype(np.float32)
    return w, b, s, c


def _jstep(aux, state):
    w, b = aux
    return jnp.tanh(state @ w + b) * 0.5


def _tstep(aux, state):
    w, b = aux
    (s,) = state
    return (torch.tanh(s @ w + b) * 0.5,)


def _counted(monkeypatch, fn):
    """Run ``fn`` (a JAX backward that reaches ``jrbp.neumann_series``)
    eagerly; (its result, the terms the last Neumann series took)."""
    original, calls = jrbp.neumann_series, []

    def counting(vjp_state, grad, truncate_iter):
        vs = []

        def vjp(v):
            out = vjp_state(v)
            vs.append(out[0])
            return out
        g = original(vjp, grad, truncate_iter)
        total = grad
        for v in vs:
            total = jax.tree.map(jnp.add, total, v)
        whole = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in
                    zip(jax.tree.leaves(total), jax.tree.leaves(g)))
        calls.append(len(vs) if (len(vs) == truncate_iter and whole) else len(vs) - 1)
        return g

    monkeypatch.setattr(jrbp, "neumann_series", counting)
    with jax.disable_jit():
        out = fn()
    monkeypatch.setattr(jrbp, "neumann_series", original)
    return out, calls[-1]


def _jax_grads(w, b, s, c, truncate=15):
    def loss(w_, b_):
        return jnp.sum(jrbp.neumann_rbp(_jstep, (w_, b_), jnp.asarray(s), truncate)
                       * jnp.asarray(c))
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(jnp.asarray(w),
                                                                   jnp.asarray(b))]


@pytest.mark.parametrize("scale,cscale", [(0.3, 0.05), (1.5, 0.01)],
                         ids=["contractive", "expansive"])
def test_neumann_rbp_matches_jax_on_a_toy_step(scale, cscale, monkeypatch):
    w, b, s, c = _toy(0, scale)
    c = c * cscale
    tw, tb = torch.from_numpy(w).requires_grad_(), torch.from_numpy(b).requires_grad_()
    trbp.neumann_rbp.terms.clear()
    (out,) = trbp.neumann_rbp(_tstep, (tw, tb), (torch.from_numpy(s),), 15)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(
        _jstep((w, b), jnp.asarray(s))), **TOL)
    (out * torch.from_numpy(c)).sum().backward()
    (terms,) = trbp.neumann_rbp.terms
    want, jax_terms = _counted(monkeypatch, lambda: _jax_grads(w, b, s, c))
    np.testing.assert_allclose(tw.grad.numpy(), want[0], **TOL)
    np.testing.assert_allclose(tb.grad.numpy(), want[1], **TOL)
    assert terms == jax_terms


@pytest.mark.parametrize("case", ["cap", "norm-of-g", "growing-v", "vanishing-v"])
def test_early_exit_rules_match_jax(case, monkeypatch):
    """``neumann_series`` on a linear J^T v = A v: each rule alone."""
    rng = np.random.default_rng(1)
    grad = (rng.standard_normal(6) * 0.01).astype(np.float32)
    a = {"cap": 0.5 * np.eye(6),
         "norm-of-g": 0.99 * np.eye(6),
         "growing-v": 1.1 * np.eye(6),
         "vanishing-v": np.zeros((6, 6))}[case].astype(np.float32)
    if case == "norm-of-g":
        grad = grad / np.linalg.norm(grad) * 0.4
    ta = torch.from_numpy(a)
    g, terms = trbp.neumann_series(lambda v: (ta @ v[0],), (torch.from_numpy(grad),), 15)
    want, jax_terms = _counted(monkeypatch, lambda: np.asarray(jrbp.neumann_series(
        lambda v: (jnp.asarray(a) @ v,), jnp.asarray(grad), 15)))
    np.testing.assert_allclose(g[0].numpy(), want, **TOL)
    assert terms == jax_terms
    assert terms == {"cap": 15, "norm-of-g": 1, "growing-v": 0, "vanishing-v": 0}[case]


B, C, T, HW, K = 3, 8, 4, 12, 5


@pytest.fixture(scope="module")
def int_pair():
    from pathtracker_tpu.models.int_circuit import InT as JInT

    x = np.random.default_rng(5).standard_normal((B, 3, T, HW, HW)).astype(np.float32)
    jm = JInT(dimensions=C, timesteps=T, kernel_size=K, grad_method="rbp")
    params = {n: np.asarray(v) for n, v in jm.init(jax.random.key(2), jnp.asarray(x))[
        "params"].items()}
    tm = TInT(dimensions=C, timesteps=T, kernel_size=K, grad_method="rbp", device="cpu")
    tm.load_state_dict(state_dict_from_jax("InT", params))
    return jm, params, tm, x


def test_int_rbp_gradients_and_terms_match_jax(int_pair, monkeypatch):
    jm, params, tm, x = int_pair
    assert not tm.use_fused
    trbp.neumann_rbp.terms.clear()
    logit, _ = tm(torch.from_numpy(x))
    names, tensors = zip(*tm.named_parameters())
    grads = torch.autograd.grad(torch.sigmoid(logit).mean(), tensors, allow_unused=True)
    ours = to_jax_params({n: torch.zeros_like(p) if g is None else g
                          for n, p, g in zip(names, tensors, grads)})
    (terms,) = trbp.neumann_rbp.terms

    def loss(p):
        return jnp.mean(jax.nn.sigmoid(jm.apply({"params": p}, jnp.asarray(x))[0]))

    want, jax_terms = _counted(monkeypatch, lambda: jax.grad(loss)(params))
    want = {n: np.asarray(g) for n, g in want.items()}
    floor = 1e-3 * max(np.abs(v).max() for v in want.values())
    for name, w in want.items():
        scale = max(np.abs(w).max(), floor)
        np.testing.assert_allclose(ours[name] / scale, w / scale, rtol=0, atol=1e-3,
                                   err_msg=name)
    for name in ("w_exc", "w_inh", "readout_dense_kernel", "preproc_kernel"):
        assert np.abs(ours[name]).max() > 0, name
    assert terms == jax_terms and terms > 0


def test_int_rbp_forward_equals_bptt(int_pair):
    """tests/test_rbp.py:101-131 in the port: the same equations, so the RBP
    forward is the BPTT forward; test mode runs the eager cell too."""
    jm, params, tm, x = int_pair
    bptt = TInT(dimensions=C, timesteps=T, kernel_size=K, device="cpu")
    bptt.load_state_dict(tm.state_dict())
    xt = torch.from_numpy(x)
    with torch.no_grad():
        l_rbp, _ = tm(xt)
        l_bptt, _ = bptt(xt)
        t_rbp = tm(xt, testmode=True)
        t_bptt = bptt(xt, testmode=True)
    assert torch.equal(l_rbp, l_bptt)
    for a, b in zip(t_rbp, t_bptt):
        assert torch.equal(a, b)
    j_logit, _ = jm.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(l_rbp.numpy(), np.asarray(j_logit), atol=1e-3, rtol=5e-3)


def test_rbp_runs_the_eager_cell_by_the_dispatch_rule():
    """JAX's dispatch (int_circuit.py:337-345): no fused cell under RBP, in
    test mode too, even where the fused cell would serve the config."""
    from pathtracker_torch.ops import int_fused as F

    mixed = dict(dimensions=32, timesteps=2, kernel_size=3, dtype="bfloat16", device="cpu")
    assert TInT(**mixed).use_fused
    model = TInT(grad_method="rbp", **mixed)
    assert not model.use_fused
    x = torch.from_numpy(np.random.default_rng(0).random((2, 3, 2, 8, 8), np.float32))
    calls = []
    plains = {name: getattr(F, name) for name in (
        "k1_attention_plain", "k2_inhibition_plain", "k3_excitation_plain")}
    try:  # every fused-cell step on the CPU reaches these
        for name, plain in plains.items():
            setattr(F, name, lambda *a, _plain=plain: calls.append(1) or _plain(*a))
        TInT(**mixed)(x)
        assert len(calls) == 3 * 2
        calls.clear()
        logit, _ = model(x)
        logit.sum().backward()
        model(x, testmode=True)
    finally:
        for name, plain in plains.items():
            setattr(F, name, plain)
    assert calls == []


def test_penalty_matches_jax():
    """relu(J^T 1 - mu)^2 by double backward: value and its gradient with
    respect to the step's weights, on a map with some columns above 0.9."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((N, N)) * 0.6).astype(np.float32)
    s = rng.standard_normal((4, N)).astype(np.float32)

    def jloss(w_):
        return jpenalty.jacobian_penalty(lambda z: jnp.tanh(z @ w_) * 1.5, jnp.asarray(s))

    tw = torch.from_numpy(w).requires_grad_()
    pen = tpenalty.jacobian_penalty(lambda z: torch.tanh(z @ tw) * 1.5, torch.from_numpy(s))
    assert float(pen.detach()) > 0
    np.testing.assert_allclose(float(pen.detach()), float(jloss(jnp.asarray(w))), **TOL)
    (dw,) = torch.autograd.grad(pen, [tw])
    np.testing.assert_allclose(dw.numpy(), np.asarray(jax.grad(jloss)(jnp.asarray(w))),
                               **TOL)
    small = tpenalty.jacobian_penalty(lambda z: 0.1 * z, torch.ones(2, 4))
    assert float(small) == 0.0
    pair = tpenalty.jacobian_penalty(lambda zs: (zs[0] * 3.0, zs[1] * 0.1),
                                     (torch.ones(2, 4), torch.ones(2, 4)))
    assert float(pair) == pytest.approx((2.1 ** 2) / 2)


def test_resident_windows_and_fused_steps_refuse_rbp():
    """Each Neumann term syncs with the host, which no CUDA graph holds:
    make_resident_train_step and the loop's flags refuse RBP."""
    from pathtracker_torch.data.resident import make_resident_train_step
    from pathtracker_torch.train import loop
    from pathtracker_torch.train.steps import make_optimizer
    from pathtracker_torch.utils.opts import parser

    model = TInT(dimensions=C, timesteps=2, kernel_size=3, grad_method="rbp", device="cpu")
    with pytest.raises(ValueError, match="rbp"):
        make_resident_train_step(model, "InT", make_optimizer(1e-3), n_clips=8,
                                 batch_size=4, fused_steps=4)
    base = ["--model", "InT", "--algo", "rbp", "--length", "8", "--dist", "1", "--speed", "1"]
    for extra in (["--fused-steps", "4"], ["--device-data"]):
        with pytest.raises(ValueError, match="rbp"):
            loop._refuse_later_slices(parser.parse_args(base + extra), torch.device("cpu"))
    loop._refuse_later_slices(parser.parse_args(base), torch.device("cpu"))
