"""pathtracker_torch.data.{prepare,pathtracker} against pathtracker_tpu.data."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracker_torch.data import pathtracker as tpt
from pathtracker_torch.data import prepare as tprep
from pathtracker_tpu.data import pathtracker as jpt
from pathtracker_tpu.data import prepare as jprep


def _imgs(seed=3):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (2, 3, 5, 6, 3), dtype=np.uint8)
    # Half the pixels saturated per channel, so the disentangle mask takes
    # every value 0..3.
    sat = rng.integers(0, 2, imgs.shape, dtype=np.uint8) * 255
    keep = rng.random(imgs.shape[:-1]) < 0.5
    imgs[keep] = sat[keep]
    return imgs, rng.integers(0, 2, (2,), dtype=np.uint8)


@pytest.mark.parametrize("disentangle,pretrained,coord",
                         list(itertools.product([False, True], repeat=3)))
def test_prepare_batch_matches_jax(disentangle, pretrained, coord):
    imgs, labels = _imgs()
    flags = dict(disentangle_channels=disentangle, pretrained_norm=pretrained,
                 coord_channels=coord)
    jx, jt = jprep.prepare_batch(jnp.asarray(imgs), jnp.asarray(labels), **flags)
    tx, tt = tprep.prepare_batch(torch.from_numpy(imgs), torch.from_numpy(labels),
                                 **flags)
    assert tx.dtype == torch.float32 and tt.dtype == torch.float32
    # XLA folds x/255 (and /std) into a multiply by the reciprocal, which
    # can differ from the division by one f32 ulp; through (x - mean)/std
    # that is at most ~3e-7 absolute.
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=3e-7, atol=5e-7)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_decode_labels_matches_jax():
    for labels in (np.array([b"\x02", b"\x01", b"\x01"]), np.array([0, 1, 1], np.uint8),
                   np.array(["\x01", "\x02"])):
        np.testing.assert_array_equal(tprep.decode_labels(labels),
                                      jprep.decode_labels(labels))


@pytest.mark.parametrize("dot_size,dist,speed", [(1, 14, 1.0), (2, 14, 1.0), (2, 5, 4.0)])
def test_renderer_matches_jax(dot_size, dist, speed):
    """Same generator state, same clips and labels, bit for bit."""
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        ours = tpt.render_pathtracker_clip(r1, timesteps=12, n_distractors=dist,
                                           speed=speed, dot_size=dot_size)
        theirs = jpt.render_pathtracker_clip(r2, timesteps=12, n_distractors=dist,
                                             speed=speed, dot_size=dot_size)
        np.testing.assert_array_equal(ours[0], theirs[0])
        assert ours[1] == theirs[1]
    clips, labels = tpt.render_batch(4, 3, timesteps=6, dot_size=dot_size)
    assert clips.shape == (3, 6, 32, 32, 3) and clips.dtype == np.uint8
    assert set(labels.tolist()) <= {0, 1}
