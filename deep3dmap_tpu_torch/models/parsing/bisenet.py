"""The compact BiSeNet (port of ``deep3dmap_tpu/models/parsing/bisenet.py``):
a spatial path of three stride-2 convs and a context path with global
context, fused by attention refinement into per-pixel class logits.  For
runs with seeded weights; the published face-parsing checkpoint imports into
``bisenet_fp.py``'s network.

Channel-last in and out, (B, H, W, 3) -> (B, H, W, n_classes).  Every conv
is flax's ``SAME`` (asymmetric at stride 2 on an even side, ``models/
layers.py``), and the submodules carry flax's auto-names (``Conv_3``,
``GroupNorm_3``, ``_ARM_0``), so ``utils/from_flax.py`` carries a JAX param
tree across leaf for leaf.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.resize import resize_bilinear
from ..builder import BACKBONES
from ..layers import Conv, GroupNorm


def add_cbr(m: nn.Module, i: int, cin: int, ch: int, k: int = 3, s: int = 1,
            dilation: int = 1) -> None:
    """Registers the ``Conv_i`` and ``GroupNorm_i`` of one flax ``_cbr``
    (conv without bias, GroupNorm of min(8, ch) groups, ReLU) on ``m``."""
    m.add_module(f"Conv_{i}", Conv(cin, ch, (k, k), s, use_bias=False, dilation=dilation))
    m.add_module(f"GroupNorm_{i}", GroupNorm(min(8, ch), ch))


def cbr(m: nn.Module, i: int, x: torch.Tensor) -> torch.Tensor:
    return F.relu(getattr(m, f"GroupNorm_{i}")(getattr(m, f"Conv_{i}")(x)))


class _ARM(nn.Module):
    """Attention refinement: a global-pool gate."""

    def __init__(self, ch: int):
        super().__init__()
        add_cbr(self, 0, ch, ch)
        self.Conv_1 = Conv(ch, ch, (1, 1), use_bias=False)
        self.GroupNorm_1 = GroupNorm(min(8, ch), ch)

    def forward(self, x):
        x = cbr(self, 0, x)
        atten = x.mean(dim=(1, 2), keepdim=True)
        return x * torch.sigmoid(self.GroupNorm_1(self.Conv_1(atten)))


@BACKBONES.register_module()
class BiSeNet(nn.Module):
    def __init__(self, n_classes: int = 19, base: int = 32):
        super().__init__()
        b = base
        # spatial path (Conv_0..2), context path (Conv_3..7)
        for i, (cin, ch, k) in enumerate([(3, b, 7), (b, 2 * b, 3), (2 * b, 4 * b, 3),
                                          (3, b, 3), (b, 2 * b, 3), (2 * b, 4 * b, 3),
                                          (4 * b, 8 * b, 3), (8 * b, 16 * b, 3)]):
            add_cbr(self, i, cin, ch, k, 2)
        self._ARM_0 = _ARM(16 * b)
        self._ARM_1 = _ARM(8 * b)
        add_cbr(self, 8, 24 * b, 4 * b)
        add_cbr(self, 9, 8 * b, 4 * b, 1)
        self.Conv_10 = Conv(4 * b, b, (1, 1))
        self.Conv_11 = Conv(b, 4 * b, (1, 1))
        self.Conv_12 = Conv(4 * b, n_classes, (1, 1))

    def forward(self, x):
        sp = x
        for i in range(3):
            sp = cbr(self, i, sp)
        c = cbr(self, 4, cbr(self, 3, x))
        c8 = cbr(self, 5, c)
        c16 = cbr(self, 6, c8)
        c32 = cbr(self, 7, c16)

        g = c32.mean(dim=(1, 2), keepdim=True)
        a32 = resize_bilinear(self._ARM_0(c32) + g, c16.shape[1:3])
        a16 = self._ARM_1(c16)
        ctx = resize_bilinear(cbr(self, 8, torch.cat([a16, a32], -1)), sp.shape[1:3])

        fused = cbr(self, 9, torch.cat([sp, ctx], -1))
        atten = F.relu(self.Conv_10(fused.mean(dim=(1, 2), keepdim=True)))
        fused = fused + fused * torch.sigmoid(self.Conv_11(atten))
        return resize_bilinear(self.Conv_12(fused), x.shape[1:3])
