"""PSPNet scene parsing and ``SceneParser`` (port of
``deep3dmap_tpu/models/parsing/pspnet.py``): a dilated trunk at 1/8
resolution, a pyramid pooling module over 1/2/3/6 bins and per-pixel class
logits.  Gan2Shape's mask prior for the non-face categories: 21 VOC classes
for car, cat and horse, 150 ADE classes for church.

Channel-last; flax's ``SAME`` convs (asymmetric at stride 2 on an even side,
dilated by 2 and 4 in the trunk) and auto-names (``Conv_4``, ``_PPM_0``), so
``utils/from_flax.py`` carries a JAX param tree across leaf for leaf.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.resize import resize_bilinear
from ..layers import Conv
from .bisenet import add_cbr, cbr
from .bisenet_fp import RegionParser


class _PPM(nn.Module):
    """Average pools of (H // b, W // b) windows (``VALID``) for each bin
    count b, a 1x1 conv each, upsampled back and concatenated to the input."""

    def __init__(self, cin: int, bins: Sequence[int] = (1, 2, 3, 6), ch: int = 64):
        super().__init__()
        self.bins = tuple(bins)
        for i in range(len(self.bins)):
            add_cbr(self, i, cin, ch, 1)

    def forward(self, x):
        _, H, W, _ = x.shape
        outs = [x]
        for i, b in enumerate(self.bins):
            k = (max(H // b, 1), max(W // b, 1))
            p = F.avg_pool2d(x.movedim(-1, 1), k, stride=k).movedim(1, -1)
            outs.append(resize_bilinear(cbr(self, i, p), (H, W)))
        return torch.cat(outs, -1)


class PSPNet(nn.Module):
    """(B, H, W, 3) -> (B, H, W, n_classes) logits."""

    def __init__(self, n_classes: int = 21, base: int = 32):
        super().__init__()
        b = base
        for i, (cin, ch, s, d) in enumerate([(3, b, 2, 1), (b, 2 * b, 2, 1),
                                             (2 * b, 4 * b, 2, 1),        # 1/8
                                             (4 * b, 8 * b, 1, 2),        # dilated
                                             (8 * b, 8 * b, 1, 4)]):
            add_cbr(self, i, cin, ch, 3, s, d)
        self._PPM_0 = _PPM(8 * b, ch=2 * b)
        add_cbr(self, 5, 16 * b, 4 * b)
        self.Conv_6 = Conv(4 * b, n_classes, (1, 1))

    def forward(self, x):
        h = x
        for i in range(5):
            h = cbr(self, i, h)
        h = cbr(self, 5, self._PPM_0(h))
        return resize_bilinear(self.Conv_6(h), x.shape[1:3])


class SceneParser(RegionParser):
    """PSPNet behind ``parse_mask`` for the scene categories; ``weights_path``
    an ``.npz`` with a ``params`` tree."""

    def __init__(self, weights_path: Optional[str] = None, n_classes: int = 21,
                 seed: int = 0, device=None):
        super().__init__(PSPNet(n_classes), weights_path, seed, device)
