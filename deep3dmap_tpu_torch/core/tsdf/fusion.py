"""TSDF fusion of depth frames, dense (port of ``deep3dmap_tpu/core/tsdf/fusion.py``).

One vectorised projective update per frame:

    sdf   = clamp((depth(px) - z) / trunc, max=1)
    valid = in-frustum & depth > 0 & depth - z >= -trunc
    tsdf  = (w*tsdf + obs*sdf) / (w + obs)   where valid

with nearest-pixel depth lookup (``torch.round`` rounds half to even, as
``jnp.round`` does), truncation ``margin * voxel_size`` and a running weighted
average, as in the reference's TSDF volume.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class TSDFParams(NamedTuple):
    dim: tuple            # (X, Y, Z)
    voxel_size: float
    margin: int = 3       # truncation = margin * voxel_size

    @property
    def sdf_trunc(self):
        return self.margin * self.voxel_size


def _world_coords(params: TSDFParams, origin: torch.Tensor, x0: int = 0) -> torch.Tensor:
    X, Y, Z = params.dim
    kw = dict(dtype=torch.float32, device=origin.device)
    gx, gy, gz = torch.meshgrid(torch.arange(x0, x0 + X, **kw), torch.arange(Y, **kw),
                                torch.arange(Z, **kw), indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1) * params.voxel_size + origin


def tsdf_integrate(tsdf, weight, depth_im, cam_intr, cam_pose, origin,
                   params: TSDFParams, obs_weight: float = 1.0, x0: int = 0):
    """Integrate one depth frame.  tsdf, weight (X, Y, Z); depth_im (H, W);
    cam_intr (3, 3); cam_pose (4, 4) camera-to-world; origin (3,).  ``x0``
    offsets the X indices: a slab of a larger volume whose first row is row
    ``x0`` (``parallel/spatial.py``), with the whole volume's coordinates."""
    H, W = depth_im.shape
    world = _world_coords(params, origin, x0)
    w2c = torch.linalg.inv(cam_pose)
    cam = world @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-6, z, torch.full_like(z, 1e-6))
    fx, fy = cam_intr[0, 0], cam_intr[1, 1]
    cx, cy = cam_intr[0, 2], cam_intr[1, 2]
    px = torch.round(cam[..., 0] * fx / safe_z + cx).to(torch.int64)
    py = torch.round(cam[..., 1] * fy / safe_z + cy).to(torch.int64)

    in_frustum = (px >= 0) & (px < W) & (py >= 0) & (py < H) & (z > 0)
    depth_val = depth_im[py.clamp(0, H - 1), px.clamp(0, W - 1)]

    trunc = params.sdf_trunc
    depth_diff = depth_val - z
    dist = torch.clamp(depth_diff / trunc, max=1.0)
    valid = in_frustum & (depth_val > 0) & (depth_diff >= -trunc)

    w_new = weight + obs_weight
    fused = (weight * tsdf + obs_weight * dist) / w_new
    return torch.where(valid, fused, tsdf), torch.where(valid, w_new, weight)


def tsdf_fuse_frames(depth_ims, cam_intrs, cam_poses, origin, params: TSDFParams):
    """Fuse N frames: depth_ims (N, H, W), cam_intrs (N, 3, 3), cam_poses
    (N, 4, 4).  Returns (tsdf, weight) each (X, Y, Z); tsdf starts at 1."""
    kw = dict(dtype=torch.float32, device=depth_ims.device)
    tsdf = torch.ones(params.dim, **kw)
    weight = torch.zeros(params.dim, **kw)
    for d, k, p in zip(depth_ims, cam_intrs, cam_poses):
        tsdf, weight = tsdf_integrate(tsdf, weight, d, k, p, origin, params)
    return tsdf, weight


def tsdf_pyramid_from_depths(depth_ims, cam_intrs, cam_poses, origin,
                             n_vox: int, voxel_size: float, n_levels: int = 3,
                             margin: int = 3):
    """GT pyramid: level l has side n_vox // 2**l and voxel size
    voxel_size * 2**l; occupancy is |tsdf| < 0.999 with weight > 1.
    Returns (tsdf_list, occ_list), finest level first."""
    tsdf_list, occ_list = [], []
    for lvl in range(n_levels):
        dim = n_vox // (2 ** lvl)
        params = TSDFParams(dim=(dim, dim, dim), voxel_size=voxel_size * 2 ** lvl,
                            margin=margin)
        tsdf, weight = tsdf_fuse_frames(depth_ims, cam_intrs, cam_poses, origin,
                                        params)
        tsdf_list.append(tsdf)
        occ_list.append((torch.abs(tsdf) < 0.999) & (weight > 1))
    return tsdf_list, occ_list
