"""Dense 3D convolution stacks (port of ``deep3dmap_tpu/models/modulars/dense3d.py``).

UNet3D mirrors SPVCNN's capacity: stem 32·cr, encoder [64·cr, 128·cr],
decoder [96·cr, 96·cr] with skip connections, cr = 1/2^level.  Layout NDHWC;
submodules carry flax's auto-names so ``utils/from_flax.py`` maps weights
leaf by leaf.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv, GroupNorm, num_groups


def _gn(channels: int) -> GroupNorm:
    # flax nn.GroupNorm default eps 1e-6 (not BlockGN's 1e-5)
    return GroupNorm(num_groups(channels), channels)


class ConvBlock3D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        # SAME padding: at stride 2 flax pads (0, 1), handled inside Conv
        self.Conv_0 = Conv(in_ch, out_ch, (kernel,) * 3, strides=stride,
                           use_bias=False)
        self.GroupNorm_0 = _gn(out_ch)

    def forward(self, x):
        return F.relu(self.GroupNorm_0(self.Conv_0(x)))


class ResBlock3D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.ConvBlock3D_0 = ConvBlock3D(in_ch, out_ch)
        self.Conv_0 = Conv(out_ch, out_ch, (3, 3, 3), use_bias=False)
        self.GroupNorm_0 = _gn(out_ch)
        self.Conv_1 = (Conv(in_ch, out_ch, (1, 1, 1), use_bias=False)
                       if in_ch != out_ch else None)

    def forward(self, x):
        h = self.GroupNorm_0(self.Conv_0(self.ConvBlock3D_0(x)))
        if self.Conv_1 is not None:
            x = self.Conv_1(x)
        return F.relu(x + h)


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample on the three spatial dims."""
    x = x.repeat_interleave(2, dim=1)
    x = x.repeat_interleave(2, dim=2)
    return x.repeat_interleave(2, dim=3)


def _crop_to(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Crop x's spatial dims to ref's (odd sizes: down + up overshoots by 1)."""
    return x[:, :ref.shape[1], :ref.shape[2], :ref.shape[3], :]


def unet_channels(cr: float):
    return [max(int(c * cr), 8) for c in (32, 64, 128, 96, 96)]


class UNet3D(nn.Module):
    """Two-down/two-up residual UNet over a dense voxel grid."""

    def __init__(self, in_ch: int, out_ch: int, cr: float = 1.0):
        super().__init__()
        cs = unet_channels(cr)
        self.ConvBlock3D_0 = ConvBlock3D(in_ch, cs[0])
        self.ConvBlock3D_1 = ConvBlock3D(cs[0], cs[1], stride=2)
        self.ResBlock3D_0 = ResBlock3D(cs[1], cs[1])
        self.ConvBlock3D_2 = ConvBlock3D(cs[1], cs[2], stride=2)
        self.ResBlock3D_1 = ResBlock3D(cs[2], cs[2])
        self.ResBlock3D_2 = ResBlock3D(cs[2] + cs[1], cs[3])
        self.ResBlock3D_3 = ResBlock3D(cs[3] + cs[0], cs[4])
        self.Conv_0 = Conv(cs[4], out_ch, (1, 1, 1))

    def forward(self, x):
        stem = self.ConvBlock3D_0(x)
        d1 = self.ResBlock3D_0(self.ConvBlock3D_1(stem))
        d2 = self.ResBlock3D_1(self.ConvBlock3D_2(d1))
        u1 = _crop_to(_up2(d2), d1)
        u1 = self.ResBlock3D_2(torch.cat([u1, d1], dim=-1))
        u2 = _crop_to(_up2(u1), stem)
        u2 = self.ResBlock3D_3(torch.cat([u2, stem], dim=-1))
        return self.Conv_0(u2)
