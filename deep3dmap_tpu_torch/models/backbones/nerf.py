"""The NeRF MLP (port of ``deep3dmap_tpu/models/backbones/nerf.py``):
positional encodings of position and direction, a ``fc_depth`` x
``fc_dim`` ReLU trunk with the encoded position concatenated again before
each layer in ``skips``, a density head and a view-dependent colour head
with a sigmoid.  Layer names are flax's (``xyz_encoding_{i}``, ``sigma``,
``xyz_encoding_final``, ``rgb1``, ``rgb2``), so weights carry across by
name (``utils/from_flax.py``)."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..builder import BACKBONES
from ..layers import Dense
from ..modulars.embeddings import embedding_out_channels, high_dim_embedding


@BACKBONES.register_module()
class NeRF(nn.Module):
    def __init__(self, xyz_freq: int = 10, dir_freq: int = 4, fc_depth: int = 8,
                 fc_dim: int = 256, skips: Sequence[int] = (4,)):
        super().__init__()
        self.xyz_freq, self.dir_freq = xyz_freq, dir_freq
        self.fc_depth, self.skips = fc_depth, tuple(skips)
        in_xyz = embedding_out_channels(3, xyz_freq)
        width = in_xyz
        for i in range(fc_depth):
            if i in self.skips:
                width += in_xyz
            setattr(self, f"xyz_encoding_{i + 1}", Dense(width, fc_dim))
            width = fc_dim
        self.sigma = Dense(fc_dim, 1)
        self.xyz_encoding_final = Dense(fc_dim, fc_dim)
        self.rgb1 = Dense(fc_dim + embedding_out_channels(3, dir_freq), fc_dim // 2)
        self.rgb2 = Dense(fc_dim // 2, 3)

    def forward(self, xyz: torch.Tensor, dirs=None, sigma_only: bool = False):
        """xyz (..., 3), dirs (..., 3).  Returns (..., 4) = rgb, sigma (or
        (..., 1) sigma with ``sigma_only``)."""
        input_xyz = high_dim_embedding(xyz, self.xyz_freq)
        h = input_xyz
        for i in range(self.fc_depth):
            if i in self.skips:
                h = torch.cat([input_xyz, h], dim=-1)
            h = torch.relu(getattr(self, f"xyz_encoding_{i + 1}")(h))
        sigma = self.sigma(h)
        if sigma_only:
            return sigma
        d = torch.cat([self.xyz_encoding_final(h), high_dim_embedding(dirs, self.dir_freq)], -1)
        rgb = torch.sigmoid(self.rgb2(torch.relu(self.rgb1(d))))
        return torch.cat([rgb, sigma], dim=-1)
