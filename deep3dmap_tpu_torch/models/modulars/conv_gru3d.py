"""Dense 3D convolutional GRU cell (port of
``deep3dmap_tpu/models/modulars/conv_gru3d.py``, unsharded path only).

    z = sigmoid(Wz * [h, x])
    r = sigmoid(Wr * [h, x])
    q = tanh(Wq * [r ⊙ h, x])
    h' = (1 - z) ⊙ h + z ⊙ q
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..layers import Conv


class ConvGRU3D(nn.Module):
    def __init__(self, hidden_dim: int, in_ch: int, kernel: int = 3):
        super().__init__()
        self.hidden_dim = hidden_dim
        k = (kernel,) * 3
        # z and r read the same input: one conv with 2C outputs
        self.convzr = Conv(hidden_dim + in_ch, 2 * hidden_dim, k)
        self.convq = Conv(hidden_dim + in_ch, hidden_dim, k)

    def forward(self, h, x):
        # TRAP (dtype promotion): a bf16 hidden window meets an fp32 x here;
        # the concat promotes to fp32, as jnp.concatenate does, and the
        # caller writes the result back to the bf16 global volume
        hx = torch.cat([h, x], dim=-1)
        zr = self.convzr(hx)
        z = torch.sigmoid(zr[..., :self.hidden_dim])
        r = torch.sigmoid(zr[..., self.hidden_dim:])
        rhx = torch.cat([r * h, x], dim=-1)
        q = torch.tanh(self.convq(rhx))
        return (1.0 - z) * h + z * q
