"""Chunked causal linear attention, FAVOR+'s numerator and denominator
(pathtracker_tpu/ops/favor.py).

The prefix sum over the per-position outer products ``kf x v`` would hold
a [B, N, H, M, D] tensor: 137 GB at batch 64 of the PathTracker shape
(N = T*H*W = 65,536 tokens, H=4 heads, M=64 features, D=32). This computes
the same quantity chunk by chunk, carrying only the running state
(KV [B,H,M,D] and Ksum [B,H,M]). Per chunk of S tokens,

    intra = (Qf Kf^T . causal_mask) V        # exact within-chunk causality
    inter = Qf . KV_state                     # all previous chunks
    den   = (Qf Kf^T . causal_mask) 1 + Qf . Ksum
    state += Kf^T V;  Ksum += sum_s Kf

Each chunk runs under ``torch.utils.checkpoint`` (the JAX scan step's
``jax.checkpoint``): backward recomputes its [B,H,S,S] products instead of
keeping them for every chunk (at batch 32 and S=1024, ~0.5 GB a tensor,
two a chunk, 64 chunks). The products are cuBLAS matmuls through
``torch.einsum``, as XLA computes them outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _chunk(kv, ksum, q, k, val, mask, eps: float):
    """One scan step: ([B,H,M,D], [B,H,M]) state and a chunk's [B,H,S,*]
    q, k, v -> (state after it, its [B,H,S,D] output)."""
    attn = torch.einsum("bhsm,bhtm->bhst", q, k) * mask
    num = torch.einsum("bhst,bhtd->bhsd", attn, val)
    num = num + torch.einsum("bhsm,bhmd->bhsd", q, kv)
    den = attn.sum(dim=-1) + torch.einsum("bhsm,bhm->bhs", q, ksum)
    out = num / (den[..., None] + eps)
    kv = kv + torch.einsum("bhsm,bhsd->bhmd", k, val)
    ksum = ksum + k.sum(dim=2)
    return kv, ksum, out


def causal_linear_attention(qf, kf, v, chunk_size: int = 1024, eps: float = 1e-6):
    """Causal FAVOR+ attention for positive features: qf, kf [B, N, H, M],
    v [B, N, H, D] -> [B, N, H, D]. The sequence is zero-padded up to a
    multiple of the chunk (padded keys add nothing to the state; padded
    outputs are sliced off)."""
    b, n, h, m = qf.shape
    d = v.shape[-1]
    s = min(chunk_size, n)
    pad = (-n) % s
    if pad:
        qf, kf, v = (F.pad(z, (0, 0, 0, 0, 0, pad)) for z in (qf, kf, v))
    nc = (n + pad) // s

    def to_chunks(z):  # [nc, B, H, S, *]
        return z.reshape(b, nc, s, h, -1).permute(1, 0, 3, 2, 4)

    qc, kc, vc = to_chunks(qf), to_chunks(kf), to_chunks(v)
    mask = torch.tril(torch.ones((s, s), dtype=qf.dtype, device=qf.device))
    kv = qf.new_zeros((b, h, m, d))
    ksum = qf.new_zeros((b, h, m))
    remat = torch.is_grad_enabled() and any(z.requires_grad for z in (qf, kf, v))
    outs = []
    for c in range(nc):
        if remat:
            kv, ksum, out = checkpoint(_chunk, kv, ksum, qc[c], kc[c], vc[c], mask, eps,
                                       use_reentrant=False, preserve_rng_state=False)
        else:
            kv, ksum, out = _chunk(kv, ksum, qc[c], kc[c], vc[c], mask, eps)
        outs.append(out)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, nc * s, h, d)
    return out[:, :n]
