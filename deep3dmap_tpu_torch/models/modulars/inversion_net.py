"""GNeRF's pose inversion net (port of
``deep3dmap_tpu/models/modulars/inversion_net.py``): a ViT from an image
patch to a pose embedding, 3 values (``"3d"``) or 9 (``"6d"``,
``pose_to_d9``).  Patchify into (imsize / p)² tokens of p = max(imsize //
16, 1) pixels, a dense embedding, a zero ``cls`` token, a learned
``pos_embed``, ``depth`` pre-norm blocks (flax's LayerNorm, attention,
tanh GELU MLP), a final LayerNorm and a dense head on the ``cls`` token.
Layer names are flax's auto-names."""
from __future__ import annotations

import torch
import torch.nn as nn

from ..builder import BACKBONES
from ..layers import Dense, LayerNorm, MultiHeadDotProductAttention, gelu


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(dim, heads)
        self.LayerNorm_1 = LayerNorm(dim)
        self.Dense_0 = Dense(dim, mlp_dim)
        self.Dense_1 = Dense(mlp_dim, dim)

    def forward(self, x):
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x))
        return x + self.Dense_1(gelu(self.Dense_0(self.LayerNorm_1(x))))


@BACKBONES.register_module()
class InversionNet(nn.Module):
    FLAX_LEAVES = {"cls": ("cls", "plain"), "pos_embed": ("pos_embed", "plain")}

    def __init__(self, imsize: int = 64, pose_mode: str = "6d", dim: int = 256,
                 depth: int = 6, heads: int = 16, mlp_dim: int = 256):
        super().__init__()
        self.imsize, self.depth = imsize, depth
        self.p = max(imsize // 16, 1)
        n_tokens = (imsize // self.p) ** 2
        self.Dense_0 = Dense(self.p * self.p * 3, dim)
        self.cls = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens + 1, dim))
        for i in range(depth):
            setattr(self, f"_Block_{i}", _Block(dim, heads, mlp_dim))
        self.LayerNorm_0 = LayerNorm(dim)
        self.Dense_1 = Dense(dim, 3 if pose_mode == "3d" else 9)

    def init_tokens(self, gen: torch.Generator) -> None:
        """flax's initialisers of the raw leaves: ``cls`` zeros,
        ``pos_embed`` normal(0.02)."""
        with torch.no_grad():
            self.cls.zero_()
            self.pos_embed.copy_(torch.randn(self.pos_embed.shape, generator=gen) * 0.02)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """img (B, imsize, imsize, 3) -> (B, 3 or 9)."""
        B, H, W, C = img.shape
        p = self.p
        x = img.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
        x = self.Dense_0(x.reshape(B, (H // p) * (W // p), p * p * C))
        x = torch.cat([self.cls.expand(B, 1, -1), x], dim=1) + self.pos_embed
        for i in range(self.depth):
            x = getattr(self, f"_Block_{i}")(x)
        return self.Dense_1(self.LayerNorm_0(x)[:, 0])
