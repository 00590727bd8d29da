"""LERF's language field (port of ``deep3dmap_tpu/models/modulars/lerf_field.py``):
multi-resolution hash grids whose concatenated features feed a CLIP head
conditioned on the physical scale (4 hidden layers, L2-normalised output)
and a DINO head (1 hidden layer); ``clip_from_hashgrid`` reuses a set of
grid features across the relevancy sweep's scales.  Children named as
flax's (``enc_{i}``, ``clip_fc{i}``, ``clip_out``, ``dino_fc0``,
``dino_out``)."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..layers import Dense
from .hashgrid import HashGridEncoding


class LERFField(nn.Module):
    def __init__(self, grid_layers: Sequence[int] = (8, 8),
                 grid_sizes: Sequence[int] = (16, 16),
                 grid_resolutions: Sequence = ((16, 128), (128, 256)),
                 clip_n_dims: int = 512, dino_n_dims: int = 384, hidden: int = 256):
        super().__init__()
        self.n_grids = len(grid_layers)
        width = 0
        for i in range(self.n_grids):
            enc = HashGridEncoding(n_levels=grid_layers[i], log2_hashmap_size=grid_sizes[i],
                                   base_res=grid_resolutions[i][0],
                                   end_res=grid_resolutions[i][1])
            setattr(self, f"enc_{i}", enc)
            width += enc.out_dim
        dims = [width + 1] + [hidden] * 4
        for i in range(4):
            setattr(self, f"clip_fc{i}", Dense(dims[i], dims[i + 1]))
        self.clip_out = Dense(hidden, clip_n_dims)
        self.dino_fc0 = Dense(width, hidden)
        self.dino_out = Dense(hidden, dino_n_dims)

    def hashgrid_features(self, positions: torch.Tensor) -> torch.Tensor:
        """positions (..., 3) in [0, 1] -> the grids' features, concatenated."""
        return torch.cat([getattr(self, f"enc_{i}")(positions) for i in range(self.n_grids)],
                         -1)

    def clip_from_hashgrid(self, feats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
        """feats (..., F), scales (..., 1) -> normalised CLIP (..., D)."""
        h = torch.cat([feats, scales], -1)
        for i in range(4):
            h = torch.relu(getattr(self, f"clip_fc{i}")(h))
        out = self.clip_out(h)
        return out / torch.sqrt((out ** 2).sum(-1, keepdim=True) + 1e-8)

    def forward(self, positions: torch.Tensor, clip_scales: torch.Tensor) -> dict:
        feats = self.hashgrid_features(positions)
        clip = self.clip_from_hashgrid(feats, clip_scales)
        dino = self.dino_out(torch.relu(self.dino_fc0(feats)))
        return {"hashgrid": feats, "clip": clip, "dino": dino}
