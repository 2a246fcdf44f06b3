"""Jacobian stability penalty (pathtracker_tpu/ops/penalty.py; reference
models/convlstm.py:154-163).

penalty = relu(J^T 1 - mu)^2 elementwise, where J = d(last state)/d(prev
state) of one cell step and mu = 0.9, averaged over its elements: it pushes
the recurrent Jacobian's column sums below 0.9 so the dynamics contract.
``J^T 1`` is one backward through the step with ``create_graph``, so the
penalty is itself differentiable (a double backward).
"""

from __future__ import annotations

import torch


def jacobian_penalty(step_fn, prev_state, mu: float = 0.9):
    """``step_fn``: a tensor (or tuple of tensors) -> the same. Returns the
    scalar mean of ``relu(J^T 1 - mu)^2`` over every element. The penalty
    carries a graph to whatever ``prev_state`` and the step depend on when
    grad mode is on."""
    single = isinstance(prev_state, torch.Tensor)
    prev = (prev_state,) if single else tuple(prev_state)
    create = torch.is_grad_enabled()
    # A new node per input (a view), so the backward counts only the paths
    # that pass through it, as jax.vjp's argument: not those through other
    # tensors the step closes over that were themselves computed from it
    # (ConvLSTM's h_{T-1} is a function of c_{T-1}). Its history stays
    # linked for the outer gradient.
    prev = tuple(p.view_as(p) if p.requires_grad else p.detach().requires_grad_()
                 for p in prev)
    with torch.enable_grad():
        last = step_fn(prev[0] if single else prev)
        last = (last,) if single else tuple(last)
        jv = torch.autograd.grad(last, prev, [torch.ones_like(t) for t in last],
                                 create_graph=create, allow_unused=True)
    jv = [torch.zeros_like(p) if v is None else v for v, p in zip(jv, prev)]
    total = sum(torch.clamp_min(v - mu, 0.0).square().sum() for v in jv)
    return total / sum(v.numel() for v in jv)
