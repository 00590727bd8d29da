"""Encoder -- compact conv encoder for view/light prediction.

Port of ``deep3dmap_tpu/models/backbones/encoder.py::Encoder``: five 4x4
stride-2 SAME convs (leaky ReLU 0.2 after the first four, ReLU after the
last), a spatial mean, a Dense to ``cout`` and an optional tanh.  NHWC in,
(B, cout) out; submodules carry flax's auto-names (``Conv_0`` ..
``Conv_4``, ``Dense_0``).  ``ResEncoder`` is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv, Dense


class Encoder(nn.Module):
    def __init__(self, cout: int = 6, nf: int = 32, activation: str = "tanh"):
        super().__init__()
        if activation not in ("tanh", "none"):
            raise ValueError(f"Encoder: unknown activation {activation!r}")
        self.activation = activation
        chans = (nf, nf * 2, nf * 4, nf * 8, nf * 8)
        c = 3        # RGB input
        for i, ch in enumerate(chans):
            setattr(self, f"Conv_{i}", Conv(c, ch, (4, 4), strides=2,
                                            use_bias=False))
            c = ch
        self.Dense_0 = Dense(nf * 8, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) -> (B, cout)."""
        for i in range(4):
            x = F.leaky_relu(getattr(self, f"Conv_{i}")(x), 0.2)
        x = F.relu(self.Conv_4(x))
        x = self.Dense_0(x.mean(dim=(1, 2)))
        return torch.tanh(x) if self.activation == "tanh" else x
