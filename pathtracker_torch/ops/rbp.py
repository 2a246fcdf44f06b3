"""Neumann-series recurrent backpropagation (RBP) as a
``torch.autograd.Function`` (pathtracker_tpu/ops/rbp.py).

The reference pattern (reference models/InT.py:10-55, convlstm.py:9-54):
unroll T-1 steps without gradient, take ONE differentiable step
``last = f(aux, prev)``, and in backward route the incoming gradient through
a truncated Neumann series ``g = sum_k (J^T)^k grad`` (J = d last / d prev)
before pulling it back through the step: the tensors in ``aux`` (parameters,
the last frame's inputs) receive ``J_aux^T g``. Early exit with the
reference's norm rules (reference InT.py:43-47, rbp.py:41-63): stop and
discard the last term when ||g|| > 1, ||v|| grew, or ||v|| < 1e-9, with at
most ``truncate_iter`` terms. Memory is O(1) in the sequence length.

Each term's exit test reads one value back to the host, so a step that
runs RBP cannot be captured into a CUDA graph; the resident windows refuse
it (data/resident.py).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable


def _norm(tensors):
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def neumann_series(vjp_state, grad, truncate_iter: int):
    """``g = sum_k (J^T)^k grad`` with the reference's early-exit rules;
    ``vjp_state(v)`` is ``J^T v`` over tuples of tensors. Returns (g, the
    number of terms added to ``grad``)."""
    v = g = tuple(grad)
    prev_normv = _norm(v)
    terms = 0
    while terms < truncate_iter:
        v_new = tuple(vjp_state(v))
        normv = _norm(v_new)
        g_new = tuple(a + b for a, b in zip(g, v_new))
        normg = _norm(g_new)
        if bool((normg > 1.0) | (normv > prev_normv) | (normv < 1e-9)):
            break
        v, g, prev_normv = v_new, g_new, normv
        terms += 1
    return g, terms


class _NeumannRBP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, step_fn, truncate_iter, n_aux, *tensors):
        ctx.step_fn, ctx.truncate_iter, ctx.n_aux = step_fn, truncate_iter, n_aux
        ctx.save_for_backward(*tensors)
        return tuple(step_fn(tensors[:n_aux], tensors[n_aux:]))

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        saved, n = ctx.saved_tensors, ctx.n_aux
        needs = ctx.needs_input_grad[3:]
        aux = tuple(t.detach().requires_grad_(need) for t, need in zip(saved[:n], needs))
        state = tuple(t.detach().requires_grad_(True) for t in saved[n:])
        with torch.enable_grad():
            out = tuple(ctx.step_fn(aux, state))

        def vjp_state(v):
            d = torch.autograd.grad(out, state, v, retain_graph=True, allow_unused=True)
            return tuple(torch.zeros_like(s) if x is None else x for x, s in zip(d, state))

        g, terms = neumann_series(vjp_state, grads, ctx.truncate_iter)
        neumann_rbp.terms.append(terms)
        leaves = [t for t, need in zip(aux + state, needs) if need]
        d = iter(torch.autograd.grad(out, leaves, g, allow_unused=True) if leaves else ())
        return (None, None, None, *(next(d) if need else None for need in needs))


def neumann_rbp(step_fn, aux, state, truncate_iter: int = 15):
    """``step_fn(aux, state)`` (tuples of tensors in, a tuple out) with the
    RBP backward. Each backward appends the number of Neumann terms it took
    to ``neumann_rbp.terms``."""
    return _NeumannRBP.apply(step_fn, truncate_iter, len(aux), *aux, *state)


neumann_rbp.terms = []
