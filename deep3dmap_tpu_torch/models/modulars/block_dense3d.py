"""Block-sparse 3D conv stacks: UNet3D / ConvGRU3D on active blocks.

Port of ``deep3dmap_tpu/models/modulars/block_dense3d.py``.  Convolutions run
as dense batched VALID convs on halo-padded active blocks
(``ops/block_sparse.gather_halo``), so compute scales with occupancy:
  * every conv sees true neighbour data through a 1-voxel halo (inactive
    neighbours read zeros, as the sparse conv's out-of-set lookup does);
  * GroupNorm statistics cover valid blocks only, in float32, eps 1e-5;
  * stride-2 down / nearest up stay inside each block (bs 8 -> 4 -> 2).

Layout (B, MAXB, bs, bs, bs, C) plus a ``BlockSet``.  ``dtype`` is the conv
compute type (bf16 on the bench config); params stay float32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.block_sparse import BlockSet, gather_halo
from ..layers import Conv, GroupNorm, num_groups
from .dense3d import unet_channels


def _mask_slots(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return x * valid[:, :, None, None, None, None].to(x.dtype)


class BlockGN(GroupNorm):
    """GroupNorm over the active voxel set (valid blocks only).

    Unlike flax's GroupNorm (``dense3d._gn``, eps 1e-6, fast variance), this
    one uses eps 1e-5 and the two-pass variance, in float32 even for bf16
    conv stacks."""

    def __init__(self, channels: int, max_groups: int = 8, eps: float = 1e-5):
        super().__init__(num_groups(channels, max_groups), channels, eps=eps)

    def forward(self, x, valid):
        x = x.float()
        C, G = x.shape[-1], self.groups
        gs = C // G
        B, maxb = x.shape[0], x.shape[1]
        xg = x.reshape(B, maxb, -1, G, gs)                  # (B, MAXB, bs³, G, gs)
        w = valid[:, :, None, None, None].to(x.dtype)
        denom = torch.clamp((w * torch.ones_like(xg[..., :1])).sum(
            dim=(1, 2, 4), keepdim=True) * gs, min=1.0)
        mean = (xg * w).sum(dim=(1, 2, 4), keepdim=True) / denom
        var = (torch.square(xg - mean) * w).sum(dim=(1, 2, 4), keepdim=True) / denom
        xn = (xg - mean) * torch.rsqrt(var + self.eps)
        out = xn.reshape(x.shape) * self.weight + self.bias
        return _mask_slots(out, valid)


class BlockConv3D(nn.Module):
    """3³ conv on halo-padded blocks: halo gather -> batched VALID conv
    (block convs need no SAME padding: the halo is the padding)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 use_bias: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.out_ch = out_ch
        self.Conv_0 = Conv(in_ch, out_ch, (3, 3, 3), strides=stride,
                           padding="VALID", use_bias=use_bias, dtype=dtype)

    def forward(self, x, bset: BlockSet):
        B, maxb, bs = x.shape[0], x.shape[1], x.shape[2]
        if self.dtype is not None:
            x = x.to(self.dtype)
        h = gather_halo(x, bset._replace(bs=bs), halo=1)
        hs = h.shape[2]
        out = self.Conv_0(h.reshape(B * maxb, hs, hs, hs, h.shape[-1]))
        os_ = out.shape[1]
        out = out.reshape(B, maxb, os_, os_, os_, self.out_ch)
        return _mask_slots(out, bset.valid)


class BlockConvBlock3D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.BlockConv3D_0 = BlockConv3D(in_ch, out_ch, stride=stride, dtype=dtype)
        self.BlockGN_0 = BlockGN(out_ch)

    def forward(self, x, bset):
        return F.relu(self.BlockGN_0(self.BlockConv3D_0(x, bset), bset.valid))


class BlockResBlock3D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.out_ch = out_ch
        self.BlockConvBlock3D_0 = BlockConvBlock3D(in_ch, out_ch, dtype=dtype)
        self.BlockConv3D_0 = BlockConv3D(out_ch, out_ch, dtype=dtype)
        self.BlockGN_0 = BlockGN(out_ch)
        self.Conv_0 = (Conv(in_ch, out_ch, (1, 1, 1), use_bias=False, dtype=dtype)
                       if in_ch != out_ch else None)

    def forward(self, x, bset):
        h = self.BlockConvBlock3D_0(x, bset)
        h = self.BlockGN_0(self.BlockConv3D_0(h, bset), bset.valid)
        if self.Conv_0 is not None:
            B, maxb, sp = x.shape[0], x.shape[1], x.shape[2]
            xb = self.Conv_0(x.reshape(B * maxb, sp, sp, sp, x.shape[-1]))
            x = xb.reshape(B, maxb, sp, sp, sp, self.out_ch)
        return F.relu(x.to(h.dtype) + h)


def _up2_block(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample inside each block."""
    x = x.repeat_interleave(2, dim=2)
    x = x.repeat_interleave(2, dim=3)
    return x.repeat_interleave(2, dim=4)


class BlockUNet3D(nn.Module):
    """Two-down/two-up residual UNet over active blocks (same capacity
    schedule as ``dense3d.UNet3D``)."""

    def __init__(self, in_ch: int, out_ch: int, cr: float = 1.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        cs = unet_channels(cr)
        dt = dtype
        self.out_ch = out_ch
        self.BlockConvBlock3D_0 = BlockConvBlock3D(in_ch, cs[0], dtype=dt)
        self.BlockConvBlock3D_1 = BlockConvBlock3D(cs[0], cs[1], stride=2, dtype=dt)
        self.BlockResBlock3D_0 = BlockResBlock3D(cs[1], cs[1], dtype=dt)
        self.BlockConvBlock3D_2 = BlockConvBlock3D(cs[1], cs[2], stride=2, dtype=dt)
        self.BlockResBlock3D_1 = BlockResBlock3D(cs[2], cs[2], dtype=dt)
        self.BlockResBlock3D_2 = BlockResBlock3D(cs[2] + cs[1], cs[3], dtype=dt)
        self.BlockResBlock3D_3 = BlockResBlock3D(cs[3] + cs[0], cs[4], dtype=dt)
        self.Conv_0 = Conv(cs[4], out_ch, (1, 1, 1), dtype=dt)

    def forward(self, x, bset: BlockSet):
        stem = self.BlockConvBlock3D_0(x, bset)
        d1 = self.BlockResBlock3D_0(self.BlockConvBlock3D_1(stem, bset), bset)
        d2 = self.BlockResBlock3D_1(self.BlockConvBlock3D_2(d1, bset), bset)
        u1 = self.BlockResBlock3D_2(torch.cat([_up2_block(d2), d1], dim=-1), bset)
        u2 = self.BlockResBlock3D_3(torch.cat([_up2_block(u1), stem], dim=-1), bset)
        B, maxb, bs = u2.shape[0], u2.shape[1], u2.shape[2]
        out = self.Conv_0(u2.reshape(B * maxb, bs, bs, bs, u2.shape[-1]))
        out = out.reshape(B, maxb, bs, bs, bs, self.out_ch).to(x.dtype)
        return _mask_slots(out, bset.valid)


class BlockConvGRU3D(nn.Module):
    """ConvGRU on active blocks.  Gate convs run in ``dtype``; the state
    update runs in ``h.dtype`` (the hidden state's storage type)."""

    def __init__(self, hidden_dim: int, in_ch: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.convzr = BlockConv3D(hidden_dim + in_ch, 2 * hidden_dim,
                                  use_bias=True, dtype=dtype)
        self.convq = BlockConv3D(hidden_dim + in_ch, hidden_dim,
                                 use_bias=True, dtype=dtype)

    def forward(self, h, x, bset: BlockSet):
        hx = torch.cat([h, x], dim=-1)
        zr = self.convzr(hx, bset).to(h.dtype)
        z = torch.sigmoid(zr[..., :self.hidden_dim])
        r = torch.sigmoid(zr[..., self.hidden_dim:])
        rhx = torch.cat([r * h, x], dim=-1)
        q = torch.tanh(self.convq(rhx, bset).to(h.dtype))
        out = (1.0 - z) * h + z * q
        return _mask_slots(out, bset.valid)
