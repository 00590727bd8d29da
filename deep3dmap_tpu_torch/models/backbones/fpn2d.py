"""MNASNet-style 2D feature-pyramid backbone, NHWC.

Port of ``deep3dmap_tpu/models/backbones/fpn2d.py``: an MBConv trunk with
three strided stages feeding a top-down FPN that emits
[C=24 @ 1/4, C=40 @ 1/8, C=80 @ 1/16] (alpha=1 depths), GroupNorm instead of
BatchNorm.  ``norm="none", torch_pad=True`` is the import mode (bias convs,
symmetric k//2 padding on strided convs).

TRAP: with ``torch_pad=False`` (the default) strided convs use flax SAME
padding, which is asymmetric at stride 2 -- (0, 1) for k=3 and (1, 2) for
k=5 on an even side.  ``layers.Conv`` applies it with an explicit pad; this
hits the stem and the strided depthwise convs of every stage.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...utils.tracing import span
from ..builder import BACKBONES
from ..layers import Conv, GroupNorm, num_groups


def _pad(kernel: int, torch_pad: bool):
    """torch-style symmetric padding, or flax SAME."""
    if torch_pad:
        p = kernel // 2
        return ((p, p), (p, p))
    return "SAME"


def _depths(alpha: float) -> list:
    """MNASNet channel scaling (asymmetric round-to-multiple-of-8)."""
    base = [32, 16, 24, 40, 80, 96, 192, 320]

    def _round(val, divisor=8, bias=0.9):
        new = max(divisor, int(val + divisor / 2) // divisor * divisor)
        return new if new >= bias * val else new + divisor

    return [_round(d * alpha) for d in base]


class _GN(nn.Module):
    """flax ``_GN``: GroupNorm (eps 1e-6), statistics in float32."""

    def __init__(self, channels: int):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(num_groups(channels), channels)

    def forward(self, x):
        return self.GroupNorm_0(x)


class _NormSlots(nn.Module):
    """Holds the ``_GN_i`` children when norm == "gn"; identity otherwise."""

    def _norm(self, i: int, x):
        gn = getattr(self, f"_GN_{i}", None)
        return x if gn is None else gn(x)


class MBConv(_NormSlots):
    """Inverted residual block: 1x1 expand -> kxk depthwise -> 1x1 project."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 expand: int = 3, norm: str = "gn", torch_pad: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        mid = in_ch * expand
        bias = norm == "none"
        self.residual = stride == 1 and in_ch == out_ch
        self.Conv_0 = Conv(in_ch, mid, (1, 1), use_bias=bias, dtype=dtype)
        self.Conv_1 = Conv(mid, mid, (kernel, kernel), strides=stride,
                           padding=_pad(kernel, torch_pad), groups=mid,
                           use_bias=bias, dtype=dtype)
        self.Conv_2 = Conv(mid, out_ch, (1, 1), use_bias=bias, dtype=dtype)
        if norm != "none":
            self._GN_0, self._GN_1, self._GN_2 = _GN(mid), _GN(mid), _GN(out_ch)

    def forward(self, x):
        h = F.relu(self._norm(0, self.Conv_0(x)))
        h = F.relu(self._norm(1, self.Conv_1(h)))
        h = self._norm(2, self.Conv_2(h))
        if self.residual:
            h = h + x
        return h


class _Stack(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 expand: int, repeats: int, norm: str = "gn",
                 torch_pad: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n = repeats
        for i in range(repeats):
            setattr(self, f"MBConv_{i}", MBConv(
                in_ch if i == 0 else out_ch, out_ch, kernel,
                stride if i == 0 else 1, expand, norm, torch_pad, dtype))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"MBConv_{i}")(x)
        return x


def _up2(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


@BACKBONES.register_module()
class MnasFPN(_NormSlots):
    """Returns [1/4 (fine), 1/8, 1/16 (coarse)] feature maps, float32."""

    def __init__(self, alpha: float = 1.0, norm: str = "gn",
                 torch_pad: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        d = _depths(alpha)
        self.channels = (d[2], d[3], d[4])
        bias = norm == "none"
        dt = dtype
        # stem: conv s2 + depthwise + project (mnasnet layers 0-7)
        self.Conv_0 = Conv(3, d[0], (3, 3), strides=2, use_bias=bias,
                           padding=_pad(3, torch_pad), dtype=dt)
        self.Conv_1 = Conv(d[0], d[0], (3, 3), groups=d[0], use_bias=bias, dtype=dt)
        self.Conv_2 = Conv(d[0], d[1], (1, 1), use_bias=bias, dtype=dt)
        if norm != "none":
            self._GN_0, self._GN_1, self._GN_2 = _GN(d[0]), _GN(d[0]), _GN(d[1])
        # stage blocks (mnasnet layers 8, 9, 10)
        self._Stack_0 = _Stack(d[1], d[2], 3, 2, 3, 3, norm, torch_pad, dt)
        self._Stack_1 = _Stack(d[2], d[3], 5, 2, 3, 3, norm, torch_pad, dt)
        self._Stack_2 = _Stack(d[3], d[4], 5, 2, 6, 3, norm, torch_pad, dt)
        # top-down FPN
        final = d[4]
        self.Conv_3 = Conv(d[4], final, (1, 1), use_bias=False, dtype=dt)
        self.Conv_4 = Conv(d[3], final, (1, 1), dtype=dt)
        self.Conv_5 = Conv(final, d[3], (3, 3), use_bias=False, dtype=dt)
        self.Conv_6 = Conv(d[2], final, (1, 1), dtype=dt)
        self.Conv_7 = Conv(final, d[2], (3, 3), use_bias=False, dtype=dt)

    def forward(self, x):
        # the span opens here, so a checkpointed trunk's recompute opens it too
        with span("nr.trunk"):
            return self._forward(x)

    def _forward(self, x):
        h = F.relu(self._norm(0, self.Conv_0(x)))
        h = F.relu(self._norm(1, self.Conv_1(h)))
        h = self._norm(2, self.Conv_2(h))
        conv0 = self._Stack_0(h)        # 1/4,  24ch
        conv1 = self._Stack_1(conv0)    # 1/8,  40ch
        conv2 = self._Stack_2(conv1)    # 1/16, 80ch

        intra = self.Conv_3(conv2)
        out_coarse = intra
        intra = _up2(intra) + self.Conv_4(conv1)
        out_mid = self.Conv_5(intra)
        intra = _up2(intra) + self.Conv_6(conv0)
        out_fine = self.Conv_7(intra)
        return [out_fine.float(), out_mid.float(), out_coarse.float()]
