"""The compact VGG trunk of the 3DMM encoder (port of
``deep3dmap_tpu/models/backbones/vgg.py::Vgg``): four stages of 3x3 convs
(64 x2, 128 x2, 256 x3, 512 x3) with GroupNorm(min(8, C)) and ReLU, each
closed by a 2x2 stride-2 VALID max pool, then a global mean and a dense layer
to ``feat_dim``.  Channel-last; flax's auto-names."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..builder import BACKBONES
from ..layers import Conv, Dense, GroupNorm

STAGES = ((64, 2), (128, 2), (256, 3), (512, 3))


@BACKBONES.register_module()
class Vgg(nn.Module):
    def __init__(self, feat_dim: int = 512):
        super().__init__()
        self.reps = [reps for _, reps in STAGES]
        c, n = 3, 0
        for ch, reps in STAGES:
            for _ in range(reps):
                setattr(self, f"Conv_{n}", Conv(c, ch, (3, 3)))
                # JAX takes min(8, C) plainly; every width here divides by 8
                setattr(self, f"GroupNorm_{n}", GroupNorm(min(8, ch), ch))
                c, n = ch, n + 1
        self.Dense_0 = Dense(c, feat_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = 0
        for reps in self.reps:
            for _ in range(reps):
                x = F.relu(getattr(self, f"GroupNorm_{n}")(getattr(self, f"Conv_{n}")(x)))
                n += 1
            # (B, H, W, C) -> NCHW for the pool; floor division, as VALID
            x = F.max_pool2d(x.movedim(-1, 1), 2, 2).movedim(1, -1)
        return self.Dense_0(x.mean(dim=(1, 2)))
