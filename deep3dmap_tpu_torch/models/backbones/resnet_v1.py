"""ResNet v1 classifier backbone (port of
``deep3dmap_tpu/models/backbones/resnet_v1.py``).

A 3x3 stem to ``stem_ch`` channels, a 2x2 stride-2 max pool padded by one
with ``-inf``, stages of ``BasicBlock``/``Bottleneck`` residuals at
``stem_ch * 2^(i+1)`` planes (the first block of each at stride 2), a mean
over the whole image and a Dense head.  GroupNorm everywhere, with the
largest group count up to 8 that divides the channels (``layers.num_groups``,
JAX's ``_norm``).  Channel-last in; submodules carry flax's auto-names, so
``utils/from_flax.py`` maps the JAX params leaf by leaf.

TRAP: flax's ``SAME`` 3x3 conv at stride 2 pads (0, 1) on an even side;
``layers.Conv`` computes flax's pads.  A 1x1 stride-2 shortcut reads
``x[::2, ::2]`` and convolves at stride 1 (the same products), as
``resfcn256.Bottleneck`` does: torch 2.13's CPU backward of a 1x1 stride-2
conv on a channels-last tensor corrupts the heap.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..builder import BACKBONES
from ..layers import Conv, Dense, GroupNorm, num_groups


def _gn(ch: int) -> GroupNorm:
    return GroupNorm(num_groups(ch), ch)


class _Shortcut(nn.Module):
    def _shortcut(self, x: torch.Tensor) -> torch.Tensor:
        if not self.project:
            return x
        s, i = self.stride, self.proj_idx
        return getattr(self, f"GroupNorm_{i}")(getattr(self, f"Conv_{i}")(x[:, ::s, ::s]))

    def _add_projection(self, idx: int, in_ch: int, out_ch: int, stride: int):
        self.stride, self.proj_idx = stride, idx
        self.project = stride != 1 or in_ch != out_ch
        if self.project:
            # flax numbers the projection after the block's own convs
            self.add_module(f"Conv_{idx}", Conv(in_ch, out_ch, (1, 1), use_bias=False))
            self.add_module(f"GroupNorm_{idx}", _gn(out_ch))


class BasicBlock(_Shortcut):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv(in_ch, planes, (3, 3), strides=stride, use_bias=False)
        self.GroupNorm_0 = _gn(planes)
        self.Conv_1 = Conv(planes, planes, (3, 3), use_bias=False)
        self.GroupNorm_1 = _gn(planes)
        self._add_projection(2, in_ch, planes, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        out = self.GroupNorm_1(self.Conv_1(out))
        return F.relu(out + self._shortcut(x))


class Bottleneck(_Shortcut):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = planes * self.expansion
        self.Conv_0 = Conv(in_ch, planes, (1, 1), use_bias=False)
        self.GroupNorm_0 = _gn(planes)
        self.Conv_1 = Conv(planes, planes, (3, 3), strides=stride, use_bias=False)
        self.GroupNorm_1 = _gn(planes)
        self.Conv_2 = Conv(planes, out_ch, (1, 1), use_bias=False)
        self.GroupNorm_2 = _gn(out_ch)
        self._add_projection(3, in_ch, out_ch, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        out = F.relu(self.GroupNorm_1(self.Conv_1(out)))
        out = self.GroupNorm_2(self.Conv_2(out))
        return F.relu(out + self._shortcut(x))


_BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


@BACKBONES.register_module()
class ResNetV1(nn.Module):
    """x (B, H, W, in_ch) -> logits (B, num_classes)."""

    def __init__(self, block: str = "basic", layers: Sequence[int] = (2, 2, 2, 2, 2),
                 num_classes: int = 1000, stem_ch: int = 16, in_ch: int = 3):
        super().__init__()
        block_cls = _BLOCKS[block]
        self.Conv_0 = Conv(in_ch, stem_ch, (3, 3), use_bias=False)
        self.GroupNorm_0 = _gn(stem_ch)
        c, n = stem_ch, 0
        self.n_blocks = sum(layers)
        self.block_name = block_cls.__name__
        for i, n_blocks in enumerate(layers):
            planes = stem_ch * (2 ** (i + 1))
            for j in range(n_blocks):
                self.add_module(f"{self.block_name}_{n}",
                                block_cls(c, planes, 2 if j == 0 else 1))
                c, n = planes * block_cls.expansion, n + 1
        self.Dense_0 = Dense(c, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        # flax's max_pool pads with -inf, as torch's implicit padding
        x = F.max_pool2d(x.movedim(-1, 1), 2, 2, padding=1).movedim(1, -1)
        for n in range(self.n_blocks):
            x = getattr(self, f"{self.block_name}_{n}")(x)
        return self.Dense_0(x.mean(dim=(1, 2)))


@BACKBONES.register_module()
class ResFCN256Cls(nn.Module):
    """The reference's ``resfcn256`` classifier factory: a BasicBlock
    [2, 2, 2, 2, 2] ``ResNetV1`` (not PRNet's position-map ``ResFCN256``)."""

    def __init__(self, num_classes: int = 1000, in_ch: int = 3):
        super().__init__()
        self.ResNetV1_0 = ResNetV1("basic", (2, 2, 2, 2, 2), num_classes, in_ch=in_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ResNetV1_0(x)
