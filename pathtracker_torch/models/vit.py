"""ViT support module (pathtracker_tpu/models/vit.py; reference
models/transformer.py:8-130, a lucidrains-style ViT that the reference
imported and never called).

Patch embedding, a cls token and a positional embedding, prenorm residual
attention and MLP blocks (the shared pieces of models/transformers.py), and
a LayerNorm + Linear head on the cls token. No ``--model`` name builds it.
"""

from __future__ import annotations

import torch
from torch import nn

from pathtracker_torch import resolve_device
from pathtracker_torch.models.transformers import _MHA, _MLP, _layer_norm, _linear
from pathtracker_torch.ops import initializers as init


class Transformer(nn.Module):
    """Prenorm residual encoder (reference transformer.py:66-84)."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 gen: torch.Generator):
        super().__init__()
        self.depth = depth
        for layer in range(depth):
            setattr(self, f"ln_a{layer}", _layer_norm(dim))
            setattr(self, f"attn{layer}", _MHA(dim, heads, dim_head, gen))
            setattr(self, f"ln_m{layer}", _layer_norm(dim))
            setattr(self, f"mlp{layer}", _MLP(dim, mlp_dim, gen))

    def forward(self, x):
        for layer in range(self.depth):
            x = x + getattr(self, f"attn{layer}")(getattr(self, f"ln_a{layer}")(x))
            x = x + getattr(self, f"mlp{layer}")(getattr(self, f"ln_m{layer}")(x))
        return x


class ViT(nn.Module):
    """Image classifier over [B, H, W, C] inputs (reference transformer.py:86-130)."""

    def __init__(self, image_size: int = 32, patch_size: int = 8, num_classes: int = 1,
                 dim: int = 128, depth: int = 2, heads: int = 4, dim_head: int = 32,
                 mlp_dim: int = 256, channels: int = 3, seed: int = 0, device=None):
        super().__init__()
        self.ps, self.dim = patch_size, dim
        n = (image_size // patch_size) ** 2
        gen = torch.Generator().manual_seed(seed)
        self.patch = _linear(patch_size * patch_size * channels, dim, gen)
        self.cls_token = nn.Parameter(init.normal(0.02)(gen, (1, 1, dim)))
        self.pos_emb = nn.Parameter(init.normal(0.02)(gen, (1, n + 1, dim)))
        self.encoder = Transformer(dim, depth, heads, dim_head, mlp_dim, gen)
        self.ln_head = _layer_norm(dim)
        self.head = _linear(dim, num_classes, gen)
        self.to(resolve_device(device))

    def forward(self, img):
        ps = self.ps
        b, h, w, c = img.shape
        ph, pw = h // ps, w // ps
        patches = img.reshape(b, ph, ps, pw, ps, c).permute(0, 1, 3, 2, 4, 5)
        tokens = self.patch(patches.reshape(b, ph * pw, ps * ps * c))
        tokens = torch.cat([self.cls_token.expand(b, 1, self.dim), tokens], dim=1)
        tokens = self.encoder(tokens + self.pos_emb)
        return self.head(self.ln_head(tokens[:, 0]))
