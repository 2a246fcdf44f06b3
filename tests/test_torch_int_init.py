"""The port's InT init against the JAX package's (models/int_init.py vs
flax's ``InT.init(jax.random.key(seed), x)``): the same params from the
same seed. Draws that go through jax.random.uniform alone are held bit for
bit; the normal draws to 1e-6 (XLA's f32 log1p rounds otherwise than
numpy's in a few percent of them) and the orthogonal kernels built on them
by QR to 1e-5 of their largest entry. A wrong key, order or initializer
moves an entry by O(its scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracker_torch.data import prng
from pathtracker_torch.models import int_init
from pathtracker_torch.models.int_circuit import InT
from pathtracker_torch.train.torch_import import to_jax_params
from pathtracker_tpu.models.int_circuit import InT as JInT

ORTHOGONAL_RTOL = 1e-5
ORTHOGONAL = {"a_w_gate_kernel", "a_u_gate_kernel", "i_w_gate_kernel", "i_u_gate_kernel",
              "e_w_gate_kernel", "e_u_gate_kernel", "w_exc", "w_inh"}
CONFIGS = {
    "canonical": dict(seed=0, dimensions=32, kernel_size=7, timesteps=2),
    "small": dict(seed=3, dimensions=8, kernel_size=3, timesteps=5),
    "chrono-lesions": dict(seed=1, dimensions=8, kernel_size=3, timesteps=6,
                           use_attention=False, lesion_alpha=True, lesion_gamma=True),
    "no-inh": dict(seed=2, dimensions=8, kernel_size=5, timesteps=4, no_inh=True),
}


def _jax_params(cfg):
    cfg = dict(cfg)
    seed, t = cfg.pop("seed"), cfg["timesteps"]
    params = JInT(**cfg).init(jax.random.key(seed), jnp.zeros((2, 3, t, 32, 32)))["params"]
    return {k: np.asarray(v) for k, v in params.items()}


def _port_draw(cfg):
    lesions = frozenset(n for n in ("alpha", "mu", "gamma", "kappa") if cfg.get(f"lesion_{n}"))
    return int_init.jax_int_params(cfg["seed"], cfg["dimensions"], cfg["kernel_size"],
                                   cfg["timesteps"], cfg.get("use_attention", True),
                                   cfg.get("no_inh", False), lesions)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_int_init_is_the_jax_packages(name):
    want, got = _jax_params(CONFIGS[name]), _port_draw(CONFIGS[name])
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].shape == value.shape and got[key].dtype == np.float32, key
        if key in ORTHOGONAL:
            scale = np.abs(value).max()
            assert np.abs(got[key] - value).max() <= ORTHOGONAL_RTOL * scale, key
        else:
            np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_int_starts_from_that_draw(name):
    cfg = dict(CONFIGS[name])
    model = InT(device="cpu", **cfg)
    drawn = _port_draw(CONFIGS[name])
    params = to_jax_params(model.state_dict())
    assert set(params) == set(drawn)
    for key, value in drawn.items():
        np.testing.assert_array_equal(np.asarray(params[key]), value, err_msg=key)


def test_draws_match_jax_random():
    key = jax.random.fold_in(jax.random.key(7), 12345)
    ours = prng.fold_in(prng.key(7), 12345)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    for minval, maxval in ((-0.3, 0.3), (1.0, 63.0), (lo, 1.0)):
        np.testing.assert_array_equal(
            int_init.uniform(ours, (1000, 7), minval, maxval),
            np.asarray(jax.random.uniform(key, (1000, 7), jnp.float32, minval, maxval)))
    want = np.asarray(jax.random.normal(key, (1000, 7), jnp.float32))
    got = int_init.normal(ours, (1000, 7))
    # An ulp of log1p's w moves erfinv's polynomial by ~1e-7 at unit scale.
    assert np.abs(got - want).max() <= 1e-6
    assert np.mean(got == want) > 0.9


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_int_init_state_dict_is_the_checkpoint_mapping(name):
    """int_init.state_dict lays the draw out as train/torch_import does."""
    from pathtracker_torch.train.torch_import import state_dict_from_jax

    cfg = CONFIGS[name]
    lesions = frozenset(n for n in ("alpha", "mu", "gamma", "kappa") if cfg.get(f"lesion_{n}"))
    got = int_init.state_dict(cfg["seed"], cfg["dimensions"], cfg["kernel_size"],
                              cfg["timesteps"], cfg.get("use_attention", True),
                              cfg.get("no_inh", False), lesions)
    want = state_dict_from_jax("InT", _port_draw(cfg))
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].shape == value.shape and got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key
