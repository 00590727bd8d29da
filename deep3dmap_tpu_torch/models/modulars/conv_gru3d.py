"""Dense 3D convolutional GRU cell (port of
``deep3dmap_tpu/models/modulars/conv_gru3d.py``).

    z = sigmoid(Wz * [h, x])
    r = sigmoid(Wr * [h, x])
    q = tanh(Wq * [r ⊙ h, x])
    h' = (1 - z) ⊙ h + z ⊙ q

``spatial`` (a process group, the ``model`` axis's) routes the gate
convolutions through ``parallel.spatial.conv_gru3d_halo``: each rank of
the group computes one X slab of the window, with a halo exchange before
each gate conv, and the slabs are gathered back (JAX's route at
``conv_gru3d.py:36-59``, whose ``shard_map`` splits and joins the global
arrays).  The parameters are the same either way.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ...parallel.collectives import GatherRows, SplitRows, group_size
from ...parallel.spatial import conv_gru3d_halo
from ..layers import Conv


class ConvGRU3D(nn.Module):
    def __init__(self, hidden_dim: int, in_ch: int, kernel: int = 3):
        super().__init__()
        self.hidden_dim = hidden_dim
        k = (kernel,) * 3
        # z and r read the same input: one conv with 2C outputs
        self.convzr = Conv(hidden_dim + in_ch, 2 * hidden_dim, k)
        self.convq = Conv(hidden_dim + in_ch, hidden_dim, k)
        self.spatial = None

    def _halo_active(self) -> bool:
        return self.spatial is not None and group_size(self.spatial) > 1

    def forward(self, h, x):
        """h (B, X, Y, Z, Ch) and x (B, X, Y, Z, Cx) -> (B, X, Y, Z, Ch).  On
        the spatial route ``x`` is the whole window (the same on every rank
        of the group) and ``h`` the whole window or this rank's X slab of
        it; the result is the whole window."""
        if self._halo_active():
            g = self.spatial
            x_blk = SplitRows.apply(x, g, 1)
            h_blk = SplitRows.apply(h, g, 1) if h.shape[1] == x.shape[1] else h
            return GatherRows.apply(conv_gru3d_halo(self, h_blk, x_blk, g), g, 1)
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
