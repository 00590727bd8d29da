"""The 3DMM shape and pose encoder (port of
``deep3dmap_tpu/models/backbones/shape_encoder.py::Shape3dmmEncoder``):
``Vgg`` features, then ``fc1`` -> ReLU -> ``fc2`` to the ``n_param``
shape and expression coefficients and ``fc3`` -> ReLU -> ``fc4`` to the 7
pose values, concatenated [param, pose].

``init_weights`` follows JAX's rule: flax's defaults everywhere, but
``fc2`` and ``fc4`` kernels from normal(1e-4) (:27, :30), so the first
predictions sit near the mean face and a zero pose."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..builder import BACKBONES
from ..layers import Dense, init_flax_defaults
from .vgg import Vgg


@BACKBONES.register_module()
class Shape3dmmEncoder(nn.Module):
    def __init__(self, n_param: int = 228, feat_dim: int = 512):
        super().__init__()
        self.feat_net = Vgg(feat_dim)
        self.fc1 = Dense(feat_dim, 512)
        self.fc2 = Dense(512, n_param)
        self.fc3 = Dense(feat_dim, 256)
        self.fc4 = Dense(256, 7)

    def init_weights(self, gen: torch.Generator) -> None:
        init_flax_defaults(self, gen)
        with torch.no_grad():
            for fc in (self.fc2, self.fc4):
                fc.weight.normal_(0.0, 1e-4, generator=gen)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        feat = self.feat_net(img)
        param = self.fc2(F.relu(self.fc1(feat)))
        pose = self.fc4(F.relu(self.fc3(feat)))
        return torch.cat([param, pose], dim=-1)
