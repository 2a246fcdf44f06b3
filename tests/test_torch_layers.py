"""pathtracker_torch.ops.{layers,initializers} against pathtracker_tpu.ops.

Mixed-policy outputs take one bf16 rounding in both packages; the two
frameworks sum the f32 products in different orders, so an output that
lies near a bf16 rounding boundary may round to the neighbouring value:
those are held to one bf16 ulp, and nearly all must be bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracker_torch.ops import initializers as tinit
from pathtracker_torch.ops import layers as T
from pathtracker_tpu.ops import layers as J

BF16 = torch.bfloat16


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_bf16_close(ours, theirs):
    ours, theirs = np.asarray(ours, np.float32), np.asarray(theirs, np.float32)
    ulp = np.spacing(np.maximum(np.abs(ours), np.abs(theirs))) * 2.0 ** 16
    assert np.all(np.abs(ours - theirs) <= ulp), np.abs(ours - theirs).max()
    assert np.mean(ours == theirs) > 0.99


@pytest.fixture
def data():
    rng = np.random.default_rng(11)
    return dict(
        x=rng.standard_normal((2, 9, 10, 8)).astype(np.float32),
        kern=rng.standard_normal((8, 6)).astype(np.float32),
        bias=rng.standard_normal((6,)).astype(np.float32),
        conv=rng.standard_normal((5, 5, 8, 6)).astype(np.float32) * 0.2,
    )


def test_softplus_matches_jax():
    x = np.linspace(-40, 40, 4001, dtype=np.float32)
    np.testing.assert_allclose(T.softplus(torch.from_numpy(x)).numpy(),
                               _np(J.softplus(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


def test_dense_f32_matches_jax(data):
    ours = T.dense(torch.from_numpy(data["x"]), torch.from_numpy(data["kern"]),
                   torch.from_numpy(data["bias"]))
    theirs = J.dense(jnp.asarray(data["x"]), jnp.asarray(data["kern"]),
                     jnp.asarray(data["bias"]))
    np.testing.assert_allclose(ours.numpy(), _np(theirs), rtol=1e-5, atol=1e-5)


def test_dense_mixed_matches_jax(data):
    ours = T.dense(torch.from_numpy(data["x"]), torch.from_numpy(data["kern"]),
                   mxu_dtype=BF16)
    theirs = J.dense(jnp.asarray(data["x"]), jnp.asarray(data["kern"]),
                     mxu_dtype=jnp.bfloat16)
    assert ours.dtype == torch.float32
    _assert_bf16_close(ours.numpy(), _np(theirs))


def test_conv2d_f32_matches_jax(data):
    oihw = np.ascontiguousarray(data["conv"].transpose(3, 2, 0, 1))
    ours = T.conv2d(torch.from_numpy(data["x"]), torch.from_numpy(oihw),
                    torch.from_numpy(data["bias"]))
    theirs = J.conv2d(jnp.asarray(data["x"]), jnp.asarray(data["conv"]),
                      jnp.asarray(data["bias"]))
    np.testing.assert_allclose(ours.numpy(), _np(theirs), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("input_bf16", [False, True])
def test_conv2d_mixed_matches_jax(data, input_bf16):
    oihw = np.ascontiguousarray(data["conv"].transpose(3, 2, 0, 1))
    x_t, x_j = torch.from_numpy(data["x"]), jnp.asarray(data["x"])
    if input_bf16:
        x_t, x_j = x_t.to(BF16), x_j.astype(jnp.bfloat16)
    ours = T.conv2d(x_t, torch.from_numpy(oihw), mxu_dtype=BF16, keep_mxu_dtype=True)
    theirs = J.conv2d(x_j, jnp.asarray(data["conv"]), mxu_dtype=jnp.bfloat16,
                      keep_mxu_dtype=True)
    assert ours.dtype == BF16 and theirs.dtype == jnp.bfloat16
    _assert_bf16_close(ours.float().numpy(), _np(theirs))
    upcast = T.conv2d(x_t.float(), torch.from_numpy(oihw), mxu_dtype=BF16)
    assert upcast.dtype == torch.float32


def test_batch_norm_and_pool_match_jax(data):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 7, 7, 8)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    ours = T.batch_norm(torch.from_numpy(x), torch.from_numpy(scale),
                        torch.from_numpy(bias))
    theirs = J.batch_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    np.testing.assert_allclose(ours.numpy(), _np(theirs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(T.global_avg_pool(torch.from_numpy(x)).numpy(),
                               _np(J.global_avg_pool(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_initializers_follow_torch_semantics():
    gen = torch.Generator().manual_seed(0)
    w = tinit.torch_orthogonal(gen, (16, 16, 1, 1))[:, :, 0, 0]
    np.testing.assert_allclose((w @ w.T).numpy(), np.eye(16), atol=1e-5)
    k = tinit.torch_orthogonal(gen, (8, 8, 5, 5)).reshape(8, -1)
    np.testing.assert_allclose((k @ k.T).numpy(), np.eye(8), atol=1e-5)
    tall = tinit.torch_orthogonal(gen, (12, 4))
    np.testing.assert_allclose((tall.T @ tall).numpy(), np.eye(4), atol=1e-5)
    u = tinit.torch_conv_default(gen, (32, 8, 7, 7))
    bound = 1.0 / np.sqrt(8 * 49)
    assert u.abs().max() <= bound and u.abs().max() > 0.9 * bound
    b = tinit.torch_conv_bias(3)(gen, (4096,))
    assert b.abs().max() <= 1 / np.sqrt(3) and b.abs().max() > 0.9 / np.sqrt(3)
    c = tinit.chrono_gate_bias(16)(gen, (4096,))
    assert c.min() >= 0 and c.max() <= np.log(15) + 1e-6
    assert torch.equal(tinit.constant(-1.0)(gen, (3,)), torch.full((3,), -1.0))
    same = torch.Generator().manual_seed(0)
    assert torch.equal(tinit.torch_orthogonal(same, (16, 16, 1, 1))[:, :, 0, 0], w)
