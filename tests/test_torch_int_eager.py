"""The port's eager InT cell (f32 parity path) against pathtracker_tpu's InT,
on the same inputs and the same weights (carried across with
pathtracker_torch.train.torch_import). Shapes and tolerances are those of
tests/test_int_parity.py: cross-framework f32 drift compounds through the
recurrence (~3e-4 at T=5), while any equation error moves values by O(0.1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracker_torch.models.int_circuit import InT as TInT
from pathtracker_torch.train.torch_import import export_reference_state_dict
from pathtracker_tpu.models.int_circuit import InT as JInT

B, C, T, H, W, K = 3, 8, 5, 12, 12, 5


def _pair(case, timesteps, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 3, timesteps, H, W)).astype(np.float32)
    jm = JInT(dimensions=C, timesteps=timesteps, kernel_size=K, **case)
    variables = jm.init(jax.random.key(1), jnp.asarray(x))
    tm = TInT(dimensions=C, timesteps=timesteps, kernel_size=K, device="cpu", **case)
    tm.load_state_dict(export_reference_state_dict(
        {k: np.asarray(v) for k, v in variables["params"].items()}), strict=True)
    assert not tm.use_fused  # the f32 path is always the eager cell
    want = jm.apply(variables, jnp.asarray(x), testmode=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), testmode=True)
    return got, want


@pytest.mark.parametrize("case", [
    {},
    {"no_inh": True},
    {"lesion_alpha": True, "lesion_gamma": True},
    {"lesion_mu": True, "lesion_kappa": True},
    {"nl": "tanh"},
    {"use_attention": False},
])
def test_int_eager_matches_jax(case):
    (logit, states, gates), (jl, js, jg) = _pair(case, T, seed=42)
    assert logit.shape == (B, 1) and states.shape == (B, T, 1, H, W)
    assert gates.shape == (B, T, C, H, W)
    np.testing.assert_allclose(logit.numpy(), np.asarray(jl), atol=1e-3, rtol=5e-3)
    np.testing.assert_allclose(states.numpy(), np.asarray(js), atol=1e-3, rtol=5e-3)
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), atol=1e-3, rtol=5e-3)


def test_int_eager_single_step_tight():
    """At T=1 (no drift accumulation) parity holds to 1e-4."""
    (logit, states, gates), (jl, js, jg) = _pair({}, 1, seed=7)
    np.testing.assert_allclose(logit.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(states.numpy(), np.asarray(js), atol=1e-4)
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), atol=1e-4)


def test_train_and_test_forward_agree():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, 3, T, H, W)).astype(np.float32))
    model = TInT(dimensions=C, timesteps=T, kernel_size=K, device="cpu")
    with torch.no_grad():
        l1, penalty = model(x)
        l2, _, _ = model(x, testmode=True)
    assert torch.equal(l1, l2) and penalty.shape == (1,)


def test_init_follows_reference_semantics():
    """Init parity (reference models/InT.py:104-131) and seeding."""
    model = TInT(dimensions=C, timesteps=16, kernel_size=K, device="cpu")
    sd = model.state_dict()
    w = sd["unit1.a_w_gate.weight"][:, :, 0, 0]
    np.testing.assert_allclose((w @ w.T).numpy(), np.eye(C), atol=1e-5)
    we = sd["unit1.w_exc"].reshape(C, -1)
    np.testing.assert_allclose((we @ we.T).numpy(), np.eye(C), atol=1e-5)
    for key, value in (("unit1.a_w_gate.bias", 1.0), ("unit1.i_w_gate.bias", -1.0),
                       ("unit1.e_u_gate.bias", -1.0), ("unit1.alpha", 1.0),
                       ("unit1.mu", 0.0), ("unit1.gamma", 0.0), ("unit1.kappa", 1.0),
                       ("unit1.bn.0.weight", 0.1), ("target_conv.bias", 0.0)):
        assert torch.all(sd[key] == value), key
    again = TInT(dimensions=C, timesteps=16, kernel_size=K, device="cpu").state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    chrono = TInT(dimensions=C, timesteps=16, kernel_size=K, use_attention=False,
                  device="cpu").state_dict()
    iw = chrono["unit1.i_w_gate.bias"]
    assert (iw >= 0).all() and (iw <= np.log(15) + 1e-6).all()
    assert torch.equal(chrono["unit1.e_w_gate.bias"], -iw)
    assert "unit1.a_w_gate.weight" not in chrono
