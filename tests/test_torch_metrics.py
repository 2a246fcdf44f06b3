"""pathtracker_torch.utils.metrics against pathtracker_tpu.utils.metrics on
the same numpy inputs. Counts and ratios of small integers are exact in f32,
so the meters compare at rtol 1e-6; the losses (log1p/exp in two libraries)
at rtol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracker_torch.utils import metrics as T
from pathtracker_tpu.utils import metrics as J


def _cases():
    rng = np.random.default_rng(0)
    target = rng.integers(0, 2, size=16).astype(np.float32)
    mixed = rng.standard_normal((16, 1)).astype(np.float32) * 2
    return {
        "mixed": (target, mixed),
        "all-negative": (target, -np.abs(mixed) - 1.0),  # nothing predicted positive
        "all-positive": (target, np.abs(mixed) + 1.0),
        "between-thresholds": (target, np.full((16, 1), 0.25, np.float32)),
        "flat-logits": (target, mixed[:, 0]),
    }


def _close(ours, theirs, rtol=1e-6):
    ours = ours if isinstance(ours, (tuple, list)) else (ours,)
    theirs = theirs if isinstance(theirs, (tuple, list)) else (theirs,)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert isinstance(a, torch.Tensor) and a.dim() == 0  # a 0-d tensor, no host value
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("case", list(_cases()))
def test_meters_match_jax(case):
    target, logits = _cases()[case]
    t, z = torch.tensor(target), torch.tensor(logits)
    _close(T.acc_scores(t, z), J.acc_scores(jnp.asarray(target), jnp.asarray(logits)))
    _close(T.eval_accuracy(t, z), J.eval_accuracy(jnp.asarray(target), jnp.asarray(logits)))
    preds = (logits.reshape(-1) > 0).astype(np.uint8)
    _close(T.metric_scores(t.to(torch.uint8), torch.tensor(preds)),
           J.metric_scores(jnp.asarray(target, jnp.uint8), jnp.asarray(preds)))


@pytest.mark.parametrize("case", list(_cases()))
def test_losses_match_jax(case):
    target, logits = _cases()[case]
    t, z = torch.tensor(target), torch.tensor(logits)
    _close(T.bce_with_logits(z, t), J.bce_with_logits(jnp.asarray(logits), jnp.asarray(target)),
           rtol=1e-5)
    want = torch.nn.functional.binary_cross_entropy_with_logits(z.reshape(-1), t)
    np.testing.assert_allclose(T.bce_with_logits(z, t).numpy(), want.numpy(), rtol=1e-5)
    for gamma, alpha in ((0.0, None), (2.0, None), (2.0, 0.25)):
        _close(T.focal_loss(z, t, gamma, alpha),
               J.focal_loss(jnp.asarray(logits), jnp.asarray(target), gamma, alpha), rtol=1e-5)


def test_uint8_labels_and_large_logits():
    """The train step hands raw uint8 labels over; BCE stays finite at +-80."""
    target = np.array([1, 0, 1, 0], np.uint8)
    logits = np.array([80.0, -80.0, -80.0, 80.0], np.float32)
    _close(T.bce_with_logits(torch.tensor(logits), torch.tensor(target)),
           J.bce_with_logits(jnp.asarray(logits), jnp.asarray(target)), rtol=1e-6)
    _close(T.acc_scores(torch.tensor(target), torch.tensor(logits)),
           J.acc_scores(jnp.asarray(target), jnp.asarray(logits)))


def test_accuracy_topk_matches_jax():
    rng = np.random.default_rng(1)
    output = rng.standard_normal((12, 7)).astype(np.float32)  # distinct values: no ties
    target = rng.integers(0, 7, size=12)
    _close(T.accuracy_topk(torch.tensor(output), torch.tensor(target), topk=(1, 3, 5)),
           J.accuracy_topk(jnp.asarray(output), jnp.asarray(target), topk=(1, 3, 5)))


def test_accuracy_topk_breaks_ties_as_jax():
    """A tie goes to the higher class index in both packages."""
    output = np.array([[1, 1, 0], [0, 2, 2]], np.float32)
    target = np.array([0, 1])
    ours = T.accuracy_topk(torch.tensor(output), torch.tensor(target), topk=(1, 2))
    theirs = J.accuracy_topk(jnp.asarray(output), jnp.asarray(target), topk=(1, 2))
    _close(ours, theirs)
    assert [float(v) for v in ours] == [0.0, 100.0]
