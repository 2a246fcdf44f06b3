"""Gradient observability tools (pathtracker_tpu/utils/gradtools.py;
reference utils/misc_functions.py:48-69, 154-192).

The reference's ``clip_grad_norm_(..., do=False)`` *printed* the global grad
norm instead of clipping unless ``do=True``; ``plot_grad_flow`` drew
per-layer mean/max bars. Here over ``{name: tensor}`` gradients keyed like
a ``state_dict``; ``grad_flow_stats`` names its rows by the JAX package's
parameter names, so both packages print the same table.
"""

from __future__ import annotations

import numpy as np
import torch

from pathtracker_torch.train.torch_import import jax_leaves, to_jax_params


def global_grad_norm(grads: dict) -> torch.Tensor:
    """L2 norm over all gradients (torch clip_grad_norm_'s total_norm)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))


def clip_grad_norm(grads: dict, max_norm: float, do: bool = False,
                   verbose: bool = False):
    """Reference semantics: report the norm; clip only when do=True.
    Returns (grads, total_norm)."""
    total = global_grad_norm(grads)
    if verbose:
        print(f"grad norm: {float(total):.6f}")
    if not do:
        return grads, total
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, total


def grad_flow_stats(grads: dict):
    """Per-parameter (JAX name, mean|grad|, max|grad|) rows for kernel-like
    parameters (the reference filtered to weights with 'bias' not in name)."""
    rows = []
    for name, leaf in jax_leaves(to_jax_params(grads)):
        if "bias" in name:
            continue
        g = np.abs(np.asarray(leaf, dtype=np.float32))
        rows.append((name.strip("[]'\" ."), float(g.mean()), float(g.max())))
    return rows


def plot_grad_flow(grads: dict, path: str | None = None):
    """Bar chart of per-layer mean/max grads (reference plot_grad_flow);
    imports matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = grad_flow_stats(grads)
    names = [r[0] for r in rows]
    means = [r[1] for r in rows]
    maxes = [r[2] for r in rows]
    fig, ax = plt.subplots(figsize=(max(6, len(rows) * 0.5), 4))
    ax.bar(np.arange(len(rows)), maxes, alpha=0.3, lw=1, color="c", label="max")
    ax.bar(np.arange(len(rows)), means, alpha=0.7, lw=1, color="b", label="mean")
    ax.hlines(0, 0, len(rows) + 1, lw=2, color="k")
    ax.set_xticks(np.arange(len(rows)))
    ax.set_xticklabels(names, rotation="vertical", fontsize=6)
    ax.set_xlim(left=-0.5, right=len(rows) - 0.5)
    ax.set_xlabel("Layers")
    ax.set_ylabel("average gradient")
    ax.set_title("Gradient flow")
    ax.grid(True)
    ax.legend()
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    plt.close(fig)
    return rows
