"""Ray sampling for GNeRF: random poses on a spherical cap, a spheric path,
rays through patch coordinates (port of
``deep3dmap_tpu/core/renderer/samples/ray_sampler.py``).

Poses are camera-to-world ``[R|t]`` (N, 3, 4) with the camera looking down
its -z axis (x right, y up); rays are packed ``[o(3), d(3), near, far]``.
``random_poses`` takes its uniform draws as a tensor (``raes``, (N, 3) in
[0, 1): azimuth, elevation, radius) or draws them from a ``torch.Generator``,
so the same numbers can be fed to both packages.  The intrinsics live on the
sampler's device (CUDA unless ``device="cpu"`` is asked for).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ....utils.device import DeviceLike, resolve_device


def _constant(like: torch.Tensor, vec) -> torch.Tensor:
    """``vec`` (a tensor, or three numbers) broadcast to ``like``'s shape, on
    its device: three fills, not a copy from the host (which would wait
    for the device)."""
    if torch.is_tensor(vec):
        return vec.to(like.dtype).expand_as(like)
    return torch.stack([torch.full_like(like[..., 0], float(c)) for c in vec], -1)


def look_at_rotation(camera_position: torch.Tensor, at=(0.0, 0.0, 0.0),
                     up=(0.0, 0.0, 1.0)) -> torch.Tensor:
    """Batched look-at rotation (N, 3, 3), columns ``x, y, z`` with +z toward
    ``at``; ``at`` is a tuple or an (N, 3) tensor.  Where ``up`` is parallel
    to z, x falls back to (1, 0, 0), as in JAX."""
    p = camera_position
    at, up = _constant(p, at), _constant(p, up)
    z = at - p
    z = z / (torch.linalg.norm(z, dim=-1, keepdim=True) + 1e-9)
    x = torch.cross(up, z, dim=-1)
    x_norm = torch.linalg.norm(x, dim=-1, keepdim=True)
    x = torch.where(x_norm > 1e-5, x / torch.clamp(x_norm, min=1e-9),
                    _constant(x, (1.0, 0.0, 0.0)))
    y = torch.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


class RaySampler:
    def __init__(self, near: float, far: float, azim_range: Sequence[float],
                 elev_range: Sequence[float], radius: Sequence[float],
                 look_at_origin: bool = True, ndc: bool = False, intrinsics=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.near = near
        self.far = far
        self.azim_range = azim_range
        self.elev_range = elev_range
        self.radius = radius
        self.look_at_origin = look_at_origin
        self.up = (0.0, 0.0, 1.0)
        self.ndc = ndc
        self.start_intrinsics = self.intrinsics = None
        if intrinsics is not None:
            self.set_start_intrinsics(intrinsics)

    def set_start_intrinsics(self, intrinsics):
        self.start_intrinsics = torch.as_tensor(np.asarray(intrinsics, np.float32),
                                                device=self.device)
        self.intrinsics = self.start_intrinsics

    def update_intrinsic(self, scale: float) -> torch.Tensor:
        K = self.start_intrinsics.clone()
        K[:2] = K[:2] * scale
        self.intrinsics = K
        return K

    def pose_draws(self, rng: Optional[torch.Generator], nbatch: int, device=None) -> dict:
        """``random_poses``' draws (on ``device``, the sampler's by default):
        ``raes`` (N, 3) uniform, and ``lookat_xy`` (N, 2) normal when the
        cameras do not look at the origin."""
        dev = self.device if device is None else device
        out = {"raes": torch.rand((nbatch, 3), generator=rng, device=dev)}
        if not self.look_at_origin:
            out["lookat_xy"] = torch.randn((nbatch, 2), generator=rng, device=dev)
        return out

    def random_poses(self, draws: dict) -> torch.Tensor:
        """(N, 3, 4) camera-to-world with the eye on the spherical cap the
        ranges give, from ``pose_draws``' tensors."""
        raes = draws["raes"]
        n = raes.shape[0]
        azims = ((raes[:, 0:1] * (self.azim_range[1] - self.azim_range[0])
                  + self.azim_range[0]) * math.pi / 180.0)
        elevs = ((raes[:, 1:2] * (self.elev_range[1] - self.elev_range[0])
                  + self.elev_range[0]) * math.pi / 180.0)
        T = torch.cat([torch.cos(elevs) * torch.cos(azims),
                       torch.cos(elevs) * torch.sin(azims), torch.sin(elevs)], -1)
        radius = raes[:, 2:] * (self.radius[1] - self.radius[0]) + self.radius[0]
        T = T * radius
        if self.look_at_origin:
            lookat = torch.zeros_like(T)
        else:
            xy = draws["lookat_xy"] * self.radius[0] * 0.01
            lookat = torch.cat([xy, torch.zeros((n, 1), dtype=T.dtype, device=T.device)], -1)
        R = look_at_rotation(T, at=lookat, up=self.up)
        return torch.cat([R, T[..., None]], -1)

    def spheric_poses(self, n: int = 120) -> torch.Tensor:
        elevs = torch.full((n, 1), sum(self.elev_range) * 0.5 * math.pi / 180.0,
                           device=self.device)
        azims = (torch.linspace(self.azim_range[0], self.azim_range[1], n,
                                device=self.device)[:, None] * math.pi / 180.0)
        radius = sum(self.radius) / len(self.radius)
        t = torch.cat([torch.cos(elevs) * torch.cos(azims),
                       torch.cos(elevs) * torch.sin(azims), torch.sin(elevs)], -1) * radius
        return torch.cat([look_at_rotation(t), t[..., None]], -1)

    def get_rays(self, coords: torch.Tensor, c2ws: torch.Tensor, img_wh) -> torch.Tensor:
        """coords (N, h, w, 2) in [-1, 1]² (channel 0 along the width);
        c2ws (N, 3, 4).  Returns rays (N, h, w, 8) = [o, d, near, far]."""
        K = self.intrinsics
        W, H = img_wh[0], img_wh[1]
        u = (coords[..., 0] + 1) * 0.5 * (W - 1)
        v = (coords[..., 1] + 1) * 0.5 * (H - 1)
        dirs = torch.stack([(u - K[0, 2]) / K[0, 0], -(v - K[1, 2]) / K[1, 1],
                            -torch.ones_like(u)], -1)
        rays_d = torch.einsum("nhwc,ndc->nhwd", dirs, c2ws[:, :3, :3])
        rays_d = rays_d / (torch.linalg.norm(rays_d, dim=-1, keepdim=True) + 1e-9)
        rays_o = c2ws[:, None, None, :3, -1].expand_as(rays_d)
        near = torch.full_like(rays_o[..., :1], self.near)
        far = torch.full_like(rays_o[..., :1], self.far)
        return torch.cat([rays_o, rays_d, near, far], -1)
