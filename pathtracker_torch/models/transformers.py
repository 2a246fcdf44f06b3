"""Transformer baselines (pathtracker_tpu/models/transformers.py; reference
models/transformers.py, which wrapped timesformer-pytorch,
performer-pytorch and lambda-networks):

  TransformerModel  TimeSformer with divided space-time attention
                    (arXiv:2102.05095): per layer, temporal attention across
                    frames at one spatial site, then spatial attention
                    within each frame, then the MLP, all prenorm residual,
                    with a cls token that joins every attention group and
                    takes the mean of its updates. Patch 32 on 32x32 frames
                    (one token a frame), depth 2, 4 heads, ``pos_emb``
                    (1, T, P, d), so the module takes ``timesteps`` and the
                    frame size.
  PerformerModel    1x1x1 preproc to 32 channels, causal FAVOR+ linear
                    attention over the (T*H*W)-token sequence (depth 1,
                    4 heads, dim_head 32; ops/favor.py, one frame of tokens
                    a chunk), the last frame's tokens into the
                    target-conditioned readout.
  LambdaModel       LambdaLayer (arXiv:2102.08602) over 2D maps whose
                    channels are (T*C): content and positional lambdas,
                    ``pos_emb`` (n, n, k, u) with n = H*W, 4 heads, k=8,
                    u=4; q and v normalised with batch statistics; then the
                    target readout with a (T*C+1)-channel conv.

Attention is plain ``einsum`` + ``softmax``, as the JAX package computes it
outside any Pallas kernel; GELU is the tanh form (``jax.nn.gelu``'s
default); LayerNorm is eps 1e-5 with the biased variance. Parameter names
are the JAX package's with ``/`` as ``.`` and ``_kernel`` as ``.weight``,
in torch's layouts ([out, in] linears, OIHW convs); the rules of
train/torch_import.py carry them across.

Contract (recurrent family): ``forward(x [B,C,T,H,W]) -> (logit [B,1],
ones(1))``; ``testmode=True`` gives ``(logit, None, None)``: these
baselines have no recurrent states or gates to show.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pathtracker_torch import resolve_device
from pathtracker_torch.models.common import fill_
from pathtracker_torch.ops import initializers as init
from pathtracker_torch.ops.favor import causal_linear_attention
from pathtracker_torch.ops.layers import conv2d, dense, global_avg_pool

LN_EPS = 1e-5


def _linear(cin: int, cout: int, gen, bias: bool = True) -> nn.Linear:
    """nn.Linear with torch's default init drawn from ``gen``."""
    lin = nn.utils.skip_init(nn.Linear, cin, cout, bias=bias)
    fill_(lin.weight, init.torch_conv_default, gen)
    if bias:
        fill_(lin.bias, init.torch_conv_bias(cin), gen)
    return lin


def _layer_norm(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=LN_EPS)


class _MHA(nn.Module):
    """Softmax multi-head attention over [B, N, D] tokens: a bias-free qkv
    projection and an output projection with bias."""

    def __init__(self, dim: int, heads: int, dim_head: int, gen):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.qkv = _linear(dim, inner * 3, gen, bias=False)
        self.out = _linear(inner, dim, gen)

    def forward(self, x):
        b, n, _ = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, self.dim_head)
        q, k, v = qkv.unbind(2)
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(self.dim_head)
        attn = attn.softmax(dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, -1)
        return self.out(out)


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, gen):
        super().__init__()
        self.fc1 = _linear(dim, hidden, gen)
        self.fc2 = _linear(hidden, dim, gen)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


def _target_readout(mod: nn.Module, feat_hwc, xc):
    """[B,H,W,C] features and frame 0's blue channel -> 5x5 'SAME' conv to
    1 channel -> spatial mean -> Linear(1, 1) logit."""
    merged = torch.cat([feat_hwc, xc[:, 0, :, :, 2:3]], dim=-1)
    out = global_avg_pool(conv2d(merged, mod.target_conv.weight, mod.target_conv.bias))
    return dense(out, mod.readout_dense.weight.t(), mod.readout_dense.bias)


def _make_target_readout(mod: nn.Module, channels: int, gen) -> None:
    mod.target_conv = nn.utils.skip_init(nn.Conv2d, channels + 1, 1, 5)
    fill_(mod.target_conv.weight, init.torch_conv_default, gen)
    fill_(mod.target_conv.bias, init.constant(0.0), gen)
    mod.readout_dense = _linear(1, 1, gen)


def _contract(logit, testmode: bool):
    if testmode:
        return logit, None, None
    return logit, torch.ones((1,), dtype=logit.dtype, device=logit.device)


# ---------------------------------------------------------------------------
# TimeSformer
# ---------------------------------------------------------------------------


class TransformerModel(nn.Module):
    def __init__(self, dimensions: int = 32, timesteps: int = 64, kernel_size: int = 15,
                 jacobian_penalty: bool = False, grad_method: str = "bptt",
                 patch_size: int = 32, depth: int = 2, heads: int = 4,
                 height: int = 32, width: int = 32, channels: int = 3,
                 seed: int = 0, device=None):
        super().__init__()
        d, ps = dimensions, patch_size
        self.d, self.ps, self.depth = d, ps, depth
        n_sp = (height // ps) * (width // ps)
        gen = torch.Generator().manual_seed(seed)
        self.patch = _linear(ps * ps * channels, d, gen)
        self.pos_emb = nn.Parameter(init.normal(0.02)(gen, (1, timesteps, n_sp, d)))
        self.cls_token = nn.Parameter(init.normal(0.02)(gen, (1, 1, d)))
        for layer in range(depth):
            setattr(self, f"ln_t{layer}", _layer_norm(d))
            setattr(self, f"time_attn{layer}", _MHA(d, heads, d, gen))
            setattr(self, f"ln_s{layer}", _layer_norm(d))
            setattr(self, f"space_attn{layer}", _MHA(d, heads, d, gen))
            setattr(self, f"ln_m{layer}", _layer_norm(d))
            setattr(self, f"mlp{layer}", _MLP(d, d * 4, gen))
            setattr(self, f"ln_mc{layer}", _layer_norm(d))
            setattr(self, f"mlp_cls{layer}", _MLP(d, d * 4, gen))
        self.ln_out = _layer_norm(d)
        self.head = _linear(d, 1, gen)
        self.to(resolve_device(device))

    def forward(self, x, testmode: bool = False):
        d, ps = self.d, self.ps
        xc = x.permute(0, 2, 3, 4, 1)  # [B,T,H,W,C]
        b, t, h, w, c = xc.shape
        ph, pw = h // ps, w // ps
        n_sp = ph * pw
        patches = xc.reshape(b, t, ph, ps, pw, ps, c).permute(0, 1, 2, 4, 3, 5, 6)
        tokens = self.patch(patches.reshape(b, t, n_sp, ps * ps * c)) + self.pos_emb
        cls = self.cls_token.expand(b, 1, d)

        for layer in range(self.depth):
            # Temporal attention: (cls + the T tokens of one spatial site);
            # cls joins every group and takes the mean update.
            seq = torch.cat([cls[:, None].expand(b, n_sp, 1, d),
                             tokens.transpose(1, 2)], dim=2)  # [B,P,1+T,D]
            seq = getattr(self, f"ln_t{layer}")(seq)
            att = getattr(self, f"time_attn{layer}")(
                seq.reshape(b * n_sp, 1 + t, d)).reshape(b, n_sp, 1 + t, d)
            cls = cls + att[:, :, 0].mean(dim=1, keepdim=True)
            tokens = tokens + att[:, :, 1:].transpose(1, 2)

            # Spatial attention: (cls + the P tokens of one frame).
            seq = torch.cat([cls[:, None].expand(b, t, 1, d), tokens], dim=2)
            seq = getattr(self, f"ln_s{layer}")(seq)
            att = getattr(self, f"space_attn{layer}")(
                seq.reshape(b * t, 1 + n_sp, d)).reshape(b, t, 1 + n_sp, d)
            cls = cls + att[:, :, 0].mean(dim=1, keepdim=True)
            tokens = tokens + att[:, :, 1:]

            # MLP on every token, cls included.
            tokens = tokens + getattr(self, f"mlp{layer}")(
                getattr(self, f"ln_m{layer}")(tokens))
            cls = cls + getattr(self, f"mlp_cls{layer}")(
                getattr(self, f"ln_mc{layer}")(cls))

        return _contract(self.head(self.ln_out(cls[:, 0])), testmode)


# ---------------------------------------------------------------------------
# Performer (causal FAVOR+)
# ---------------------------------------------------------------------------


def favor_features(x, proj, is_query: bool, seq_axis: int = 1):
    """Positive softmax-kernel features (FAVOR+): x [..., d], proj [m, d]
    (pathtracker_tpu/models/transformers.py:172-189). Queries take a
    per-position stabiliser, which cancels in the attention ratio; keys one
    that is global over the sequence, since a per-key max would reweight
    key j against key j' by exp(max_j - max_j'). Both are constants to
    the gradient."""
    d = x.shape[-1]
    x = x / d ** 0.25
    xw = torch.einsum("...d,md->...m", x, proj)
    sq = x.square().sum(dim=-1, keepdim=True) / 2.0
    if is_query:
        stab = xw.amax(dim=-1, keepdim=True)
    else:
        stab = xw.amax(dim=(seq_axis, -1), keepdim=True)
    return torch.exp(xw - sq - stab.detach()) / math.sqrt(proj.shape[0]) + 1e-6


class _FavorAttention(nn.Module):
    """The Performer layer's bias-free qkv and output projections."""

    def __init__(self, dim: int, inner: int, gen):
        super().__init__()
        self.qkv = _linear(dim, inner * 3, gen, bias=False)
        self.out = _linear(inner, dim, gen, bias=False)


class PerformerModel(nn.Module):
    def __init__(self, dimensions: int = 32, timesteps: int = 64, kernel_size: int = 15,
                 jacobian_penalty: bool = False, grad_method: str = "bptt",
                 heads: int = 4, depth: int = 1, n_features: int = 64,
                 seed: int = 0, device=None):
        super().__init__()
        c = self.c = 32  # the reference pins hgru_size=32 whatever `dimensions` is
        self.heads, self.depth = heads, depth
        gen = torch.Generator().manual_seed(seed)
        self.preproc = _linear(3, c, gen)
        # Fixed orthogonal random features, a parameter that the forward
        # detaches: it sits in the state_dict and the optimizer's state
        # (zero moments, as optax keeps them) and never moves.
        self.favor_proj = nn.Parameter(init.favor_orthogonal_features(gen, (n_features, c)))
        for layer in range(depth):
            setattr(self, f"ln_a{layer}", _layer_norm(c))
            setattr(self, f"attn{layer}", _FavorAttention(c, heads * c, gen))
            setattr(self, f"ln_f{layer}", _layer_norm(c))
            setattr(self, f"ff{layer}", _MLP(c, c * 4, gen))
        _make_target_readout(self, c, gen)
        self.to(resolve_device(device))

    def forward(self, x, testmode: bool = False):
        c, dh, heads = self.c, self.c, self.heads
        xc = x.permute(0, 2, 3, 4, 1)
        b, t, h, w, _ = xc.shape
        tokens = self.preproc(xc).reshape(b, t * h * w, c)
        proj = self.favor_proj.detach() * math.sqrt(dh)
        for layer in range(self.depth):
            attn = getattr(self, f"attn{layer}")
            z = getattr(self, f"ln_a{layer}")(tokens)
            q, k, v = attn.qkv(z).reshape(b, -1, 3, heads, dh).unbind(2)
            qf = favor_features(q, proj, is_query=True)  # [B,N,H,M]
            kf = favor_features(k, proj, is_query=False, seq_axis=1)
            # One frame of tokens a chunk.
            att = causal_linear_attention(qf, kf, v, chunk_size=h * w)
            tokens = tokens + attn.out(att.reshape(b, -1, heads * dh))
            tokens = tokens + getattr(self, f"ff{layer}")(
                getattr(self, f"ln_f{layer}")(tokens))
        last = tokens.reshape(b, t, h, w, c)[:, -1]
        return _contract(_target_readout(self, last, xc), testmode)


# ---------------------------------------------------------------------------
# Lambda layer
# ---------------------------------------------------------------------------


class _BatchStat(nn.Module):
    """The lambda layer's BN: per-feature batch statistics over (batch,
    position), biased variance, eps 1e-5, affine of the feature shape."""

    def __init__(self, shape):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))

    def forward(self, z):
        mean = z.mean(dim=(0, 1))
        var = z.var(dim=(0, 1), correction=0)
        return (z - mean) * torch.rsqrt(var + 1e-5) * self.weight + self.bias


class LambdaModel(nn.Module):
    def __init__(self, dimensions: int = 32, timesteps: int = 64, kernel_size: int = 15,
                 jacobian_penalty: bool = False, grad_method: str = "bptt",
                 heads: int = 4, dim_k: int = 8, dim_u: int = 4,
                 height: int = 32, width: int = 32, seed: int = 0, device=None):
        super().__init__()
        c = self.c = dimensions
        dim = timesteps * c  # time folded into channels
        self.heads, self.dim_k, self.dim_u = heads, dim_k, dim_u
        self.v_dim = dim // heads
        n = height * width
        gen = torch.Generator().manual_seed(seed)
        self.preproc = _linear(3, c, gen)
        self.to_q = _linear(dim, dim_k * heads, gen, bias=False)
        self.to_k = _linear(dim, dim_k * dim_u, gen, bias=False)
        self.to_v = _linear(dim, self.v_dim * dim_u, gen, bias=False)
        self.pos_emb = nn.Parameter(init.normal(1.0)(gen, (n, n, dim_k, dim_u)))
        self.bn_q = _BatchStat((heads, dim_k))
        self.bn_v = _BatchStat((self.v_dim, dim_u))
        _make_target_readout(self, dim, gen)
        self.to(resolve_device(device))

    def forward(self, x, testmode: bool = False):
        c, heads, kdim, u = self.c, self.heads, self.dim_k, self.dim_u
        xc = x.permute(0, 2, 3, 4, 1)
        b, t, h, w, _ = xc.shape
        xbn = F.softplus(self.preproc(xc))  # [B,T,H,W,C]
        n, dim = h * w, t * c
        flat = xbn.permute(0, 2, 3, 1, 4).reshape(b, n, dim)  # [B,HW,T*C]
        q = self.bn_q(self.to_q(flat).reshape(b, n, heads, kdim))
        kk = self.to_k(flat).reshape(b, n, kdim, u).softmax(dim=1)  # over context positions
        v = self.bn_v(self.to_v(flat).reshape(b, n, self.v_dim, u))

        lam_c = torch.einsum("bmku,bmvu->bkv", kk, v)  # content lambda
        y_c = torch.einsum("bnhk,bkv->bnhv", q, lam_c)
        lam_p = torch.einsum("nmku,bmvu->bnkv", self.pos_emb, v)  # positional lambdas
        y_p = torch.einsum("bnhk,bnkv->bnhv", q, lam_p)
        out = (y_c + y_p).reshape(b, h, w, heads * self.v_dim)
        return _contract(_target_readout(self, out, xc), testmode)
