"""ResFCN256, PRNet's position-map regression backbone (port of
``deep3dmap_tpu/models/backbones/resfcn256.py``).

A 4x4 stem to ``base`` channels, five stages of two ``Bottleneck`` blocks
(the first with stride 2) down to R/32 at 32 * base channels, then six
``_UpBlock``s back to R (nearest x2 and 4x4 convs with GroupNorm and ReLU)
and two 4x4 convs with biases and a sigmoid.  Channel-last in and out.

TRAP: flax's ``SAME`` 4x4 conv at stride 1 pads (1, 2), low then high, not
torch's symmetric padding; ``layers.Conv`` computes flax's pads.  The norms
take ``num_groups(C)`` groups: JAX's ``_gn`` (:20) takes min(8, C) and
decreases it until it divides C, which is that function.  Submodules carry
flax's auto-names, so ``utils/from_flax.py`` maps the JAX params leaf by leaf.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv, GroupNorm, num_groups
from .encoder_decoder import _up2


def _gn(ch: int) -> GroupNorm:
    return GroupNorm(num_groups(ch), ch)


class Bottleneck(nn.Module):
    """1x1 -> 4x4 (stride) -> 1x1 with GroupNorm, and a 1x1 projection of
    the shortcut where the stride or the width changes."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        half = out_ch // 2
        self.Conv_0 = Conv(in_ch, half, (1, 1), use_bias=False)
        self.GroupNorm_0 = _gn(half)
        self.Conv_1 = Conv(half, half, (4, 4), strides=stride, use_bias=False)
        self.GroupNorm_1 = _gn(half)
        self.Conv_2 = Conv(half, out_ch, (1, 1), use_bias=False)
        self.GroupNorm_2 = _gn(out_ch)
        self.stride = stride
        self.project = stride != 1 or in_ch != out_ch
        if self.project:
            self.Conv_3 = Conv(in_ch, out_ch, (1, 1), use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        h = F.relu(self.GroupNorm_1(self.Conv_1(h)))
        h = self.GroupNorm_2(self.Conv_2(h))
        if not self.project:
            return F.relu(h + x)
        # flax's SAME 1x1 conv at stride s pads nothing and reads x[::s, ::s];
        # subsample, then convolve at stride 1: the same products.  TRAP:
        # torch 2.13's CPU backward of a 1x1 stride-2 conv on a channels-last
        # tensor corrupts the heap
        s = self.stride
        return F.relu(h + self.Conv_3(x[:, ::s, ::s]))


class _UpBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n_convs: int = 1, upsample: bool = True):
        super().__init__()
        self.upsample = upsample
        self.n_convs = n_convs
        for i in range(n_convs):
            setattr(self, f"Conv_{i}", Conv(in_ch if i == 0 else out_ch, out_ch, (4, 4),
                                            use_bias=False))
            setattr(self, f"GroupNorm_{i}", _gn(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.upsample:
            x = _up2(x)
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"GroupNorm_{i}")(getattr(self, f"Conv_{i}")(x)))
        return x


class ResFCN256(nn.Module):
    """Input (B, R, R, 3) in [0, 1]; output (B, R, R, out_ch) in (0, 1)."""

    def __init__(self, out_ch: int = 3, base: int = 16):
        super().__init__()
        b = base
        self.Conv_0 = Conv(3, b, (4, 4), use_bias=False)
        self.GroupNorm_0 = _gn(b)
        c, n = b, 0
        for ch in (2 * b, 4 * b, 8 * b, 16 * b, 32 * b):
            for stride in (2, 1):
                setattr(self, f"Bottleneck_{n}", Bottleneck(c, ch, stride))
                c, n = ch, n + 1
        # decoder: R/32 -> R with the reference's channel schedule
        ups = [(32 * b, 1, False), (16 * b, 3, True), (8 * b, 3, True),
               (4 * b, 3, True), (2 * b, 2, True), (b, 2, True)]
        for i, (ch, n_convs, upsample) in enumerate(ups):
            self.add_module(f"_UpBlock_{i}", _UpBlock(c, ch, n_convs, upsample))
            c = ch
        self.Conv_1 = Conv(b, out_ch, (4, 4))
        self.Conv_2 = Conv(out_ch, out_ch, (4, 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        for i in range(10):
            h = getattr(self, f"Bottleneck_{i}")(h)
        for i in range(6):
            h = getattr(self, f"_UpBlock_{i}")(h)
        return torch.sigmoid(self.Conv_2(self.Conv_1(h)))
