"""Synthetic ScanNet-like fragments: SDF scenes ray-marched to depth.

The port's own copy of ``deep3dmap_tpu/datasets/synthetic.py``: scenes are a
floor plane plus random spheres; depth is sphere-traced per camera (numpy);
the GT TSDF pyramid is fused from those depths with ``core/tsdf/fusion.py``.
Projection matrices follow SeqIntrinsicsPoseToProjection (per-level scaled
intrinsics) plus the world_to_aligned_camera rotation from the middle view.
The same seed gives the same fragment as the JAX package's generator.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.tsdf.fusion import tsdf_pyramid_from_depths
from ..utils.device import resolve_device


# ---------------------------------------------------------------------------
# scene SDF + rendering
# ---------------------------------------------------------------------------

def scene_sdf(pts: np.ndarray, spheres: np.ndarray, floor_z: float) -> np.ndarray:
    """pts (..., 3); spheres (K, 4) = (cx, cy, cz, r).  Returns (...)."""
    d = pts[..., 2] - floor_z
    for s in spheres:
        ds = np.linalg.norm(pts - s[:3], axis=-1) - s[3]
        d = np.minimum(d, ds)
    return d


def sphere_trace_depth(intr: np.ndarray, cam_pose: np.ndarray, H: int, W: int,
                       spheres: np.ndarray, floor_z: float, max_depth: float = 6.0,
                       iters: int = 48) -> np.ndarray:
    """Ray-march the scene SDF.  cam_pose is camera-to-world.  Returns (H, W)
    metric depth along the camera z axis (0 where no hit)."""
    fx, fy, cx, cy = intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2]
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    dirs_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], axis=-1)
    dirs_world = dirs_cam @ cam_pose[:3, :3].T
    origin = cam_pose[:3, 3]

    t = np.full((H, W), 0.05, np.float32)
    for _ in range(iters):
        pts = origin + dirs_world * t[..., None]
        d = scene_sdf(pts, spheres, floor_z).astype(np.float32)
        t = np.minimum(t + np.maximum(d, 1e-4), max_depth * 2)
    pts = origin + dirs_world * t[..., None]
    hit = scene_sdf(pts, spheres, floor_z) < 2e-2
    # camera-z depth = t * z-component of the unit-z camera ray param
    depth = t  # dirs_cam has z == 1, so t parameterizes camera depth directly
    depth = np.where(hit & (depth < max_depth), depth, 0.0)
    return depth.astype(np.float32)


def _rodrigues(axis: np.ndarray, theta: float) -> np.ndarray:
    axis = axis / (np.linalg.norm(axis) + 1e-12)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def look_at_pose(eye: np.ndarray, target: np.ndarray, up=(0, 0, 1)) -> np.ndarray:
    """Camera-to-world with +z forward, +x right, +y down (vision convention)."""
    f = target - eye
    f = f / np.linalg.norm(f)
    up = np.asarray(up, np.float32)
    r = np.cross(f, up)
    r = r / (np.linalg.norm(r) + 1e-12)
    d = np.cross(f, r)  # image down
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = r, d, f, eye
    return pose


def align_xyplane_rotation(middle_pose: np.ndarray) -> np.ndarray:
    """Rotation taking world +z into camera -y for the middle view (parity:
    transforms_seq.py:64-72 rotate_view_to_align_xyplane)."""
    z_c = (np.linalg.inv(middle_pose) @ np.array([0, 0, 1, 0.0]))[:3]
    axis = np.cross(z_c, np.array([0, -1, 0.0]))
    n = np.linalg.norm(axis)
    if n < 1e-8:
        return np.eye(3, dtype=np.float32)
    theta = np.arccos(np.clip(-z_c[1] / np.linalg.norm(z_c), -1, 1))
    return _rodrigues(axis / n, theta).astype(np.float32)


def build_proj_matrices(intr: np.ndarray, poses: Sequence[np.ndarray], n_scales: int,
                        stride: int = 4) -> np.ndarray:
    """(V, n_scales, 4, 4) combined K[R|t] per level (transforms_seq.py:81-93)."""
    out = []
    for pose in poses:
        w2c = np.linalg.inv(pose)
        view = []
        for s in range(n_scales):
            K = intr.copy() / (stride * 2 ** s)
            K[2, 2] = 1.0
            P = w2c.copy()
            P[:3, :4] = K @ w2c[:3, :4]
            view.append(P)
        out.append(np.stack(view))
    return np.stack(out).astype(np.float32)


# ---------------------------------------------------------------------------
# fragment sample
# ---------------------------------------------------------------------------

def make_fragment_sample(seed: int = 0, n_views: int = 9, img_size=(64, 64),
                         n_vox: int = 24, voxel_size: float = 0.08,
                         n_layers: int = 3, scene_reset: bool = True,
                         spheres: Optional[np.ndarray] = None,
                         device=None) -> Dict:
    """One ScanNet-style fragment dict (unbatched) of numpy arrays.  The GT
    TSDF pyramid is fused with ``core/tsdf/fusion.py`` on ``device``."""
    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    H, W = img_size
    extent = n_vox * voxel_size
    center = np.array([extent / 2, extent / 2, 0.35 * extent], np.float32)
    floor_z = 0.1 * extent
    if spheres is None:
        k = rs.randint(2, 4)
        spheres = np.stack([
            np.concatenate([
                center[:2] + rs.uniform(-0.2, 0.2, 2) * extent,
                [floor_z + rs.uniform(0.15, 0.4) * extent],
                [rs.uniform(0.1, 0.22) * extent]])
            for _ in range(k)]).astype(np.float32)

    intr = np.array([[W, 0, W / 2], [0, W, H / 2], [0, 0, 1]], np.float32)

    radius = 1.1 * extent
    angles = np.linspace(0, 0.9 * np.pi, n_views) + rs.uniform(0, 0.1)
    poses, depths, imgs = [], [], []
    for a in angles:
        eye = center + np.array([radius * np.cos(a), radius * np.sin(a), 0.45 * extent])
        pose = look_at_pose(eye, center)
        depth = sphere_trace_depth(intr, pose, H, W, spheres, floor_z,
                                   max_depth=3.0 * extent)
        img = np.where(depth > 0, 1.0 - depth / (3.0 * extent), 0.0)
        imgs.append(np.stack([img] * 3, axis=-1).astype(np.float32))
        poses.append(pose)
        depths.append(depth)

    vol_origin = np.zeros(3, np.float32)
    vol_origin_partial = vol_origin.copy()

    rot = align_xyplane_rotation(poses[n_views // 2])
    w2ac = np.eye(4, dtype=np.float32)
    w2ac[:3, :3] = rot
    w2ac = w2ac @ np.linalg.inv(poses[n_views // 2])

    proj = build_proj_matrices(intr, poses, n_layers)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    tsdf_list, occ_list = tsdf_pyramid_from_depths(
        t(np.stack(depths)), t(np.stack([intr] * n_views)), t(np.stack(poses)),
        t(vol_origin_partial), n_vox, voxel_size, n_levels=n_layers)
    tsdf_list = [x.cpu().numpy() for x in tsdf_list]
    occ_list = [o.cpu().numpy().astype(np.float32) for o in occ_list]

    return dict(
        imgs=np.stack(imgs),                       # (V, H, W, 3)
        depth=np.stack(depths),                    # (V, H, W)
        intrinsics=np.stack([intr] * n_views),
        extrinsics=np.stack(poses),
        proj_matrices=proj,                        # (V, L, 4, 4)
        vol_origin=vol_origin,
        vol_origin_partial=vol_origin_partial,
        world_to_aligned_camera=w2ac.astype(np.float32),
        tsdf_list=tsdf_list,                       # level l: (n_vox/2^l)^3
        occ_list=occ_list,
        scene_reset=np.float32(scene_reset),
    )
