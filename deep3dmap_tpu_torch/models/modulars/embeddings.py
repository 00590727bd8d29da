"""Positional encodings and learnable camera poses (port of
``deep3dmap_tpu/models/modulars/embeddings.py``).

``take_rows`` is JAX's ``x[idx]`` on an integer index array, kept for the
pose gathers: an index past the end reads the last row (JAX clamps a
gather's indices) and its gradient is dropped (the scatter-add of the
backward drops out-of-range updates).  ``configs/gnerf/`` trains with one
val pose (``tools/train.py`` builds no val dataset for a one-entry
workflow), so the val sequences and ``forward_test`` index it with the
train batch's and the test split's indices, and reach this rule at the
first step.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ...core.renderer.samples.ray_sampler import look_at_rotation


def high_dim_embedding(x: torch.Tensor, n_freqs: int, logscale: bool = True) -> torch.Tensor:
    """(..., C) -> (..., C * (2 * n_freqs + 1)): x, then sin and cos of
    f * x for each frequency f."""
    if logscale:
        freqs = [2.0 ** k for k in range(n_freqs)]
    else:
        freqs = torch.linspace(1.0, 2.0 ** (n_freqs - 1), n_freqs).tolist()
    out = [x]
    for f in freqs:
        out.append(torch.sin(f * x))
        out.append(torch.cos(f * x))
    return torch.cat(out, dim=-1)


def embedding_out_channels(in_channels: int, n_freqs: int) -> int:
    return in_channels * (2 * n_freqs + 1)


def r6d2mat(d6: torch.Tensor) -> torch.Tensor:
    """6D rotation representation -> (..., 3, 3) by Gram-Schmidt, rows
    b1, b2, b1 x b2."""
    a1, a2 = d6[..., :3], d6[..., 3:6]
    b1 = a1 / (torch.linalg.norm(a1, dim=-1, keepdim=True) + 1e-9)
    a2p = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2p / (torch.linalg.norm(a2p, dim=-1, keepdim=True) + 1e-9)
    b3 = torch.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def pose_to_d9(pose: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) [R|t] -> (..., 9): t, then R's first two rows."""
    t = pose[..., :3, 3]
    r = pose[..., :2, :3].reshape(pose.shape[:-2] + (6,))
    return torch.cat([t, r], dim=-1)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` as JAX computes it: negative indices count from the end,
    indices past either end read the nearest row, and those rows get no
    gradient."""
    n = x.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    rows = x[torch.clamp(idx, 0, n - 1)]
    valid = ((idx >= 0) & (idx < n)).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(valid, rows, rows.detach())


class PoseParameters(nn.Module):
    """Learnable per-image camera poses: ``poses_embed`` (N, 3) positions
    (``"3d"``, the rotation by look-at) or (N, 9) ``pose_to_d9`` rows
    (``"6d"``), initialised at (0, 0, 1) looking at the origin."""

    FLAX_LEAVES = {"poses_embed": ("poses_embed", "plain")}

    def __init__(self, length: int, pose_mode: str = "6d"):
        super().__init__()
        self.length = length
        self.pose_mode = pose_mode
        self.poses_embed = nn.Parameter(self.initial_embed())

    def initial_embed(self) -> torch.Tensor:
        t = torch.tensor([[0.0, 0.0, 1.0]]).repeat(self.length, 1)
        if self.pose_mode == "3d":
            return t
        return pose_to_d9(torch.cat([look_at_rotation(t), t[..., None]], -1))

    def forward(self, pose_indices=None) -> torch.Tensor:
        """(N, 3, 4) poses, or those at ``pose_indices`` (``take_rows``)."""
        embed = self.poses_embed
        t = embed[:, :3]
        R = look_at_rotation(t) if self.pose_mode == "3d" else r6d2mat(embed[:, 3:9])
        poses = torch.cat([R, t[..., None]], -1)
        return poses if pose_indices is None else take_rows(poses, pose_indices)
