"""Expert parallelism over a mesh axis (pathtracker_tpu/parallel/moe.py).

A router and a bank of two-layer GELU MLPs whose expert dimension is split
over a mesh axis, so each rank holds only its slice of the experts:

  * Router: dense logits ``x @ router_w`` -> softmax -> top-1 gate: the
    argmax expert keeps its softmax probability, the others are zeroed, so
    the router trains through the gate value.
  * Experts: ``gelu(x @ w1 + b1) @ w2 + b2`` over a stacked leading expert
    axis, GELU in its tanh form (``jax.nn.gelu``'s default).
  * Sharded (``moe_apply_sharded``): each rank routes its rows over every
    expert, computes its local experts on its rows, masks them by their
    gates, and one differentiable sum over the expert axis combines; rows
    split over a data axis when ``batch_axis`` names one.

The layouts are JAX's (``router_w`` [d_in, E], ``w1`` [E, d_in, d_hidden],
``w2`` [E, d_hidden, d_in]), so JAX's arrays carry across unchanged.
``moe_apply`` is the single-device semantics the sharded one is held to.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pathtracker_torch import resolve_device
from pathtracker_torch.parallel.collectives import psum_replicated, replicated_input


def init_moe_params(generator: torch.Generator, n_experts: int, d_in: int,
                    d_hidden: int, dtype=torch.float32, device=None) -> dict:
    """Expert bank and router, JAX's distributions (moe.py:42-57): the
    router N(0, 1/d_in), w1 and w2 He-normal, the biases zero, drawn from
    ``generator`` (a CPU one) and placed on ``device`` (``None`` means
    cuda). Leading axis = expert."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    s1, s2 = (2.0 / d_in) ** 0.5, (2.0 / d_hidden) ** 0.5
    params = {"router_w": normal(d_in, n_experts) / d_in ** 0.5,
              "w1": s1 * normal(n_experts, d_in, d_hidden),
              "b1": torch.zeros(n_experts, d_hidden),
              "w2": s2 * normal(n_experts, d_hidden, d_in),
              "b2": torch.zeros(n_experts, d_in)}
    device = resolve_device(device)
    return {k: v.to(device=device, dtype=dtype) for k, v in params.items()}


def _experts(w1, b1, w2, b2, x):
    """Every expert of the stack on the rows ``x`` [N, d]: [E, N, d]."""
    h = F.gelu(torch.einsum("nd,edh->enh", x, w1) + b1[:, None], approximate="tanh")
    return torch.einsum("enh,ehd->end", h, w2) + b2[:, None]


def _gates(router_w, x):
    """Top-1 soft gates [N, E] (moe.py:170-178)."""
    logits = x @ router_w
    probs = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(logits.argmax(dim=-1), router_w.shape[-1]).to(probs.dtype)
    return probs * onehot


def moe_apply(params: dict, x):
    """Single-device semantics: y = sum_e gate_e(x) * expert_e(x); ``x``
    [N, d_in] rows, returns [N, d_in]."""
    gates = _gates(params["router_w"], x)
    ys = _experts(params["w1"], params["b1"], params["w2"], params["b2"], x)
    return torch.einsum("ne,end->nd", gates, ys)


def shard_moe_params(mesh, params: dict, expert_axis: str = "expert") -> dict:
    """This rank's slice of the expert bank over ``expert_axis``; the router
    whole (every rank routes its own rows)."""
    axis = mesh.axis(expert_axis)
    n = params["router_w"].shape[-1]
    if n % axis.size:
        raise ValueError(f"{n} experts over an expert axis of {axis.size}")
    local = n // axis.size
    return {k: (v if k == "router_w" else v.narrow(0, axis.rank * local, local)).clone()
            for k, v in params.items()}


def moe_apply_sharded(mesh, params: dict, x, *, expert_axis: str = "expert",
                      batch_axis: str | None = None):
    """``moe_apply`` with the experts split over ``expert_axis``
    (``params`` this rank's slice, as ``shard_moe_params`` gives it) and,
    with ``batch_axis``, ``x`` this rank's rows over that axis. The gates
    are the full row's, masked to the local experts; the local experts'
    mix is summed over the axis. In backward the gates' and the rows'
    cotangents from the local experts are summed over the axis, and each
    rank keeps its experts' gradients; a data axis's mean is the caller's,
    as for any replicated parameter (the router)."""
    axis = mesh.axis(expert_axis)
    n_local = params["w1"].shape[0]
    gates = _gates(params["router_w"], x)
    local_gates = replicated_input(gates, axis).narrow(1, axis.rank * n_local, n_local)
    ys = _experts(params["w1"], params["b1"], params["w2"], params["b2"],
                  replicated_input(x, axis))
    return psum_replicated(torch.einsum("ne,end->nd", local_gates, ys), axis)
