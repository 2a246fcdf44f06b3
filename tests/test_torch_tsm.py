"""pathtracker_torch.ops.tsm against pathtracker_tpu.ops.tsm on the same
seeded inputs. The shift only moves values, so the two agree exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracker_torch.ops.tsm import tsm as ttsm
from pathtracker_tpu.ops.tsm import tsm as jtsm


@pytest.mark.parametrize("version", ["zero", "circulant"])
@pytest.mark.parametrize("shape", [(2, 5, 3, 4, 16), (1, 4, 2, 2, 11), (2, 1, 3, 3, 8)])
def test_tsm_matches_jax_exactly(version, shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jtsm(jnp.asarray(x), version))
    got = ttsm(torch.from_numpy(x), version)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_tsm_moves_an_eighth_each_way():
    x = torch.arange(2 * 3 * 16, dtype=torch.float32).reshape(2, 3, 1, 1, 16)
    y = ttsm(x)
    assert torch.equal(y[:, :-1, ..., :2], x[:, 1:, ..., :2])  # a frame forward
    assert torch.equal(y[:, -1, ..., :2], torch.zeros(2, 1, 1, 2))
    assert torch.equal(y[:, 1:, ..., 2:4], x[:, :-1, ..., 2:4])  # a frame backward
    assert torch.equal(y[..., 4:], x[..., 4:])  # the rest stays


def test_tsm_rejects_unknown_version():
    with pytest.raises(ValueError):
        ttsm(torch.zeros(1, 2, 1, 1, 8), "mirror")
