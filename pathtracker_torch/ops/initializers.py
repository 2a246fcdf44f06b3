"""Parameter initializers with the reference's torch semantics
(pathtracker_tpu/ops/initializers.py:29-110), for the InT family, the zoo
and the transformers.

Every initializer is ``init(generator, shape) -> f32 CPU tensor`` over
torch's own layouts (OIHW convs, [out, in] linears), drawing from the
explicit ``torch.Generator``:
  * torch's default Conv/Linear init: U(-1/sqrt(fan_in), +1/sqrt(fan_in))
    for both weight and bias;
  * ``orthogonal_`` on a weight flattened to [O, I*kh*kw] (a 1x1 gate and a
    k x k conv alike), made orthonormal by QR with Haar sign correction;
  * chrono gate bias: log U(1, T-1) (reference intent at models/InT.py:127);
  * FAVOR+ random features: stacked Haar d x d blocks with unit-norm rows;
  * constants.
"""

from __future__ import annotations

import math

import torch


def _uniform(gen, shape, bound):
    return torch.empty(shape).uniform_(-bound, bound, generator=gen)


def _fan_in(shape) -> int:
    return math.prod(shape[1:])


def torch_conv_default(gen, shape):
    """torch default weight init of a conv ([O, I, *k]) or linear ([out, in])."""
    return _uniform(gen, shape, 1.0 / math.sqrt(_fan_in(shape)))


def torch_conv_bias(fan_in: int):
    """Bias initializer for a conv/linear with the given fan-in."""

    def init(gen, shape):
        return _uniform(gen, shape, 1.0 / math.sqrt(fan_in))

    return init


def torch_orthogonal(gen, shape):
    """torch ``orthogonal_`` (gain 1) on the [O, prod(rest)] view:
    orthonormal rows, or orthonormal columns where O exceeds prod(rest)."""
    rows, cols = shape[0], math.prod(shape[1:])
    n, m = (rows, cols) if rows >= cols else (cols, rows)
    q, r = torch.linalg.qr(torch.randn((n, m), generator=gen))
    q = q * torch.sign(torch.diagonal(r))[None, :]  # Haar, as torch does
    if rows < cols:
        q = q.T
    return q.reshape(shape).contiguous()


def favor_orthogonal_features(gen, shape):
    """FAVOR+ random-feature matrix [m, d]: ceil(m/d) independent Haar d x d
    blocks stacked, every row unit-norm (performer-pytorch's
    gaussian_orthogonal_random_matrix; pathtracker_tpu/ops/initializers.py:64-75).
    Not ``torch_orthogonal`` on [m, d]: for m > d that gives orthonormal
    COLUMNS, whose m rows have norm ~sqrt(d/m), and the projections then
    wash attention out to uniform. The caller scales rows by sqrt(d)."""
    m, d = shape
    blocks = [torch_orthogonal(gen, (d, d)) for _ in range(-(-m // d))]
    return torch.cat(blocks, dim=0)[:m].contiguous()


def chrono_gate_bias(timesteps: int):
    """Chrono init: bias ~ log U(1, T-1)."""

    def init(gen, shape):
        hi = max(float(timesteps - 1), 1.0 + 1e-6)
        return torch.log(torch.empty(shape).uniform_(1.0, hi, generator=gen))

    return init


def normal(stddev: float):
    """N(0, stddev^2)."""

    def init(gen, shape):
        return stddev * torch.randn(shape, generator=gen)

    return init


def constant(value: float):
    def init(gen, shape):
        return torch.full(shape, float(value))

    return init
