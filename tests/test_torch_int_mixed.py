"""The port's mixed-bf16 InT, eager cell (fused=False) and fused cell
(fused=True, plain kernel versions on the CPU), against pathtracker_tpu's
InT(dtype='bfloat16', fused=...) with the Pallas kernels in interpret mode.
Shapes and tolerances are those of tests/test_int_fused.py: 1e-4 on logits,
1e-3 on the stacked per-step states and gates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracker_torch.models.int_circuit import InT as TInT
from pathtracker_torch.train.torch_import import export_reference_state_dict
from pathtracker_tpu.models.int_circuit import InT as JInT

B, C, T, HW, K = 4, 32, 5, 16, 5


@pytest.mark.parametrize("fused", [False, True])
def test_int_mixed_matches_jax(fused):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, 3, T, HW, HW)).astype(np.float32)
    jm = JInT(dimensions=C, timesteps=T, kernel_size=K, dtype="bfloat16", fused=fused)
    params = jm.init(jax.random.key(0), jnp.asarray(x))["params"]
    tm = TInT(dimensions=C, timesteps=T, kernel_size=K, dtype="bfloat16",
              fused=fused, device="cpu")
    tm.load_state_dict(export_reference_state_dict(
        {k: np.asarray(v) for k, v in params.items()}), strict=True)
    assert tm.use_fused == fused

    jl, js, jg = jm.apply({"params": params}, jnp.asarray(x), testmode=True)
    with torch.no_grad():
        logit, states, gates = tm(torch.from_numpy(x), testmode=True)
        plain_logit, _ = tm(torch.from_numpy(x))
    np.testing.assert_allclose(logit.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(states.numpy(), np.asarray(js), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), rtol=1e-3, atol=1e-3)
    assert torch.equal(plain_logit, logit)


@pytest.mark.parametrize("kwargs,fused", [
    ({"dtype": "bfloat16"}, True),
    ({"dtype": "float32"}, False),
    ({"dtype": "bfloat16", "fused": False}, False),
    ({"dtype": "bfloat16", "dimensions": 24}, False),
    ({"dtype": "bfloat16", "no_inh": True}, False),
    ({"dtype": "bfloat16", "use_attention": False}, False),
    ({"dtype": "bfloat16", "nl": "tanh"}, False),
    ({"dtype": "bfloat16", "lesion_alpha": True}, False),
    ({"dtype": "bfloat16", "lesion_kappa": True}, False),
])
def test_fused_dispatch_follows_the_config(kwargs, fused):
    """The fused cell covers exactly the JAX package's fused configs
    (int_circuit.py:340-345), decided at construction."""
    kwargs = {"dimensions": 32, "timesteps": 2, "kernel_size": 3, **kwargs}
    model = TInT(device="cpu", **kwargs)
    assert model.use_fused == fused
    with torch.no_grad():
        logit, _ = model(torch.zeros(1, 3, 2, 5, 7))  # 35 rows: a ragged tile
    assert logit.shape == (1, 1) and torch.isfinite(logit).all()
