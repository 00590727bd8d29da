"""Encoder -- compact conv encoder for view/light prediction.

Port of ``deep3dmap_tpu/models/backbones/encoder.py::Encoder``: five 4x4
stride-2 SAME convs (leaky ReLU 0.2 after the first four, ReLU after the
last), a spatial mean, a Dense to ``cout`` and an optional tanh.  NHWC in,
(B, cout) out; submodules carry flax's auto-names (``Conv_0`` ..
``Conv_4``, ``Dense_0``).

``ResEncoder``: a 4x4 stride-2 stem, ``ResBlockDown``s (leaky ReLU 0.2,
4x4 stride 2 and 3x3 convs, plus a 1x1 stride-2 skip) down to 4x4, a 4x4
VALID conv to 1x1 and a 1x1 projection to ``cout``.  The skip reads
``x[::2, ::2]`` and convolves at stride 1 (the same products; torch 2.13's
CPU backward of a 1x1 stride-2 conv on a channels-last tensor corrupts the
heap).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..builder import BACKBONES
from ..layers import Conv, Dense


@BACKBONES.register_module()
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


class ResBlockDown(nn.Module):
    """Stride-2 residual downsampling block."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, (4, 4), strides=2, use_bias=False)
        self.Conv_1 = Conv(cout, cout, (3, 3), use_bias=False)
        self.Conv_2 = Conv(cin, cout, (1, 1), use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(F.leaky_relu(x, 0.2))
        h = self.Conv_1(F.leaky_relu(h, 0.2))
        return h + self.Conv_2(x[:, ::2, ::2])


@BACKBONES.register_module()
class ResEncoder(nn.Module):
    """x (B, size, size, in_ch) -> (B, cout)."""

    def __init__(self, cout: int = 512, nf: int = 16, size: int = 128,
                 activation: str = "none", in_ch: int = 3):
        super().__init__()
        if activation not in ("tanh", "none"):
            raise ValueError(f"ResEncoder: unknown activation {activation!r}")
        self.activation = activation
        self.Conv_0 = Conv(in_ch, nf, (4, 4), strides=2, use_bias=False)
        c, chans = nf, [nf * 2, nf * 4, nf * 8]
        for _ in range(max(int(math.log2(size)) - 6, 0)):
            nf *= 2
            chans.append(nf * 8)
        for i, ch in enumerate(chans):
            self.add_module(f"ResBlockDown_{i}", ResBlockDown(c, ch))
            c = ch
        self.n_blocks = len(chans)
        self.Conv_1 = Conv(c, nf * 16, (4, 4), padding="VALID", use_bias=False)
        self.Conv_2 = Conv(nf * 16, cout, (1, 1), use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(x)
        for i in range(self.n_blocks):
            h = getattr(self, f"ResBlockDown_{i}")(h)
        h = F.relu(self.Conv_1(F.relu(h)))
        out = self.Conv_2(h).reshape(h.shape[0], -1)
        return torch.tanh(out) if self.activation == "tanh" else out
