"""The benchmark's inputs, made on the device from the seed.

A PyTorch rewrite of the sphere scene of the port's
``datasets/synthetic.py::make_fragment_sample``: a floor plane and spheres,
depth sphere-traced per view (48 steps), images shaded by depth, cameras on
an arc around the fragment looking at its centre (focal length = image
width), projection matrices per pyramid level (intrinsics / (4 · 2^s)), the
rotation that aligns the middle view with the xy plane.  The targets are the
scene's signed distance, truncated at 3 voxels of each level (occupancy:
|tsdf| < 0.999), where the port fuses traced depths: the same surfaces,
without host work.

Two layouts:
- ``train_pool``: fragments of their own scenes (one fragment per scene, the
  window at the scene's origin, as ``make_fragment_sample`` makes them),
  stacked into batches;
- ``stream_path``: one large scene and a closed path of fragments through
  it, each fragment's window at its own offset in the scene.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

TRACE_STEPS = 48
TRUNC_VOXELS = 3.0


def mix(seed: int, stream: int) -> int:
    """A generator seed for one stream of draws of a run's seed."""
    return (int(seed) * 1000003 + stream * 7919 + 17) % (2 ** 62)


def _uniform(gen, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device, dtype=torch.float64)


def scene_sdf(p, spheres, floor_z):
    """p (..., 3) float32; spheres (K, 4) -> signed distance (...)."""
    d = p[..., 2] - floor_z
    for s in spheres:
        d = torch.minimum(d, torch.linalg.vector_norm(p - s[:3], dim=-1) - s[3])
    return d


def look_at(eye, target):
    """Camera-to-world (4, 4), +z forward, +x right, +y down, world up +z."""
    f = target - eye
    f = f / f.norm()
    up = torch.tensor([0.0, 0.0, 1.0], dtype=eye.dtype, device=eye.device)
    r = torch.linalg.cross(f, up)
    r = r / (r.norm() + 1e-12)
    d = torch.linalg.cross(f, r)
    pose = torch.eye(4, dtype=eye.dtype, device=eye.device)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = r, d, f, eye
    return pose


def _rodrigues(axis, theta):
    K = torch.zeros((3, 3), dtype=axis.dtype, device=axis.device)
    K[0, 1], K[0, 2], K[1, 0] = -axis[2], axis[1], axis[2]
    K[1, 2], K[2, 0], K[2, 1] = -axis[0], -axis[1], axis[0]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return eye + torch.sin(theta) * K + (1 - torch.cos(theta)) * (K @ K)


def world_to_aligned(middle_pose):
    """The middle view's world-to-camera, turned so world +z is camera -y."""
    inv = torch.linalg.inv(middle_pose)
    z_c = inv[:3, 2]
    down = torch.tensor([0.0, -1.0, 0.0], dtype=z_c.dtype, device=z_c.device)
    axis = torch.linalg.cross(z_c, down)
    n = axis.norm()
    w2ac = torch.eye(4, dtype=z_c.dtype, device=z_c.device)
    if float(n) >= 1e-8:
        theta = torch.arccos(torch.clamp(-z_c[1] / z_c.norm(), -1.0, 1.0))
        w2ac[:3, :3] = _rodrigues(axis / n, theta)
    return w2ac @ inv


def trace_depth(intr, pose, H, W, spheres, floor_z, max_depth):
    """(H, W) camera-z depth, 0 where the ray hits nothing."""
    dev = pose.device
    v, u = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                          torch.arange(W, device=dev, dtype=torch.float32),
                          indexing="ij")
    fx, fy, cx, cy = (float(intr[0, 0]), float(intr[1, 1]), float(intr[0, 2]),
                      float(intr[1, 2]))
    dirs = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1)
    dirs = dirs @ pose[:3, :3].float().T
    o = pose[:3, 3].float()
    t = torch.full((H, W), 0.05, device=dev)
    for _ in range(TRACE_STEPS):
        d = scene_sdf(o + dirs * t[..., None], spheres, floor_z)
        t = torch.clamp(t + torch.clamp(d, min=1e-4), max=2 * max_depth)
    hit = scene_sdf(o + dirs * t[..., None], spheres, floor_z) < 2e-2
    return torch.where(hit & (t < max_depth), t, torch.zeros_like(t))


def targets(spheres, floor_z, origin, n_vox, voxel_size, n_levels):
    """Per level, finest first: tsdf (d, d, d) and occupancy (float32)."""
    tsdf_list, occ_list = [], []
    dev = origin.device
    for lvl in range(n_levels):
        d = n_vox // 2 ** lvl
        vs = voxel_size * 2 ** lvl
        r = torch.arange(d, device=dev, dtype=torch.float32)
        g = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1) * vs + origin
        tsdf = torch.clamp(scene_sdf(g, spheres, floor_z) / (TRUNC_VOXELS * vs), -1.0, 1.0)
        tsdf_list.append(tsdf)
        occ_list.append((tsdf.abs() < 0.999).float())
    return tsdf_list, occ_list


def _fragment(spheres, floor_z, target, origin, eyes, H, W, n_vox, voxel_size,
              n_levels, max_depth, with_targets):
    dev = origin.device
    intr = torch.tensor([[W, 0, W / 2], [0, W, H / 2], [0, 0, 1]], dtype=torch.float64,
                        device=dev)
    poses = [look_at(e, target) for e in eyes]
    imgs = []
    for pose in poses:
        depth = trace_depth(intr, pose, H, W, spheres, floor_z, max_depth)
        img = torch.where(depth > 0, 1.0 - depth / max_depth, torch.zeros_like(depth))
        imgs.append(img[..., None].expand(H, W, 3))
    proj = []
    for pose in poses:
        w2c = torch.linalg.inv(pose)
        lv = []
        for s in range(n_levels):
            K = intr / (4 * 2 ** s)
            K[2, 2] = 1.0
            P = w2c.clone()
            P[:3, :4] = K @ w2c[:3, :4]
            lv.append(P)
        proj.append(torch.stack(lv))
    frag = dict(imgs=torch.stack(imgs).float(), proj_matrices=torch.stack(proj).float(),
                vol_origin_partial=origin.float(),
                world_to_aligned_camera=world_to_aligned(poses[len(poses) // 2]).float())
    if with_targets:
        t, o = targets(spheres, floor_z, origin.float(), n_vox, voxel_size, n_levels)
        frag["tsdf_list"], frag["occ_list"] = t, o
    return frag


def _arc_eyes(target, radius, height, start, span, n):
    a = start + torch.linspace(0.0, span, n, dtype=torch.float64, device=target.device)
    return [target + torch.stack([radius * torch.cos(x), radius * torch.sin(x),
                                  torch.full_like(x, height)]) for x in a]


def stack(frags: List[Dict], reset: bool) -> Dict:
    """Fragments -> one batch (B first), as the port's loaders stack them."""
    out = {}
    for k in frags[0]:
        if isinstance(frags[0][k], list):
            out[k] = [torch.stack([f[k][i] for f in frags]) for i in range(len(frags[0][k]))]
        else:
            out[k] = torch.stack([f[k] for f in frags])
    B = len(frags)
    dev = out["imgs"].device
    out["vol_origin"] = torch.zeros((B, 3), device=dev)
    if reset:
        out["scene_reset"] = torch.ones((B,), device=dev)
    return out


def train_pool(seed: int, n_batches: int, batch: int, views: int, hw, n_vox: int,
               voxel_size: float, n_levels: int, device) -> List[Dict]:
    """``n_batches`` batches of ``batch`` fragments, each of its own scene of
    three spheres (``make_fragment_sample``'s layout), every batch with the
    scene-reset flag set."""
    H, W = hw
    ext = n_vox * voxel_size
    out = []
    for b in range(n_batches):
        frags = []
        for j in range(batch):
            gen = torch.Generator(device=device).manual_seed(mix(seed, 1000 + b * batch + j))
            centre = torch.tensor([ext / 2, ext / 2, 0.35 * ext], dtype=torch.float64,
                                  device=device)
            floor_z = 0.1 * ext
            sph = []
            for _ in range(3):
                u = _uniform(gen, 5, 0.0, 1.0, device)
                sph.append(torch.stack([
                    centre[0] + (u[0] * 0.4 - 0.2) * ext, centre[1] + (u[1] * 0.4 - 0.2) * ext,
                    floor_z + (0.15 + 0.25 * u[2]) * ext, (0.1 + 0.12 * u[3]) * ext]))
            spheres = torch.stack(sph).float()
            start = float(_uniform(gen, 1, 0.0, 0.1, device)[0])
            eyes = _arc_eyes(centre, 1.1 * ext, 0.45 * ext, start, 0.9 * math.pi, views)
            frags.append(_fragment(spheres, floor_z, centre,
                                   torch.zeros(3, dtype=torch.float64, device=device),
                                   eyes, H, W, n_vox, voxel_size, n_levels, 3.0 * ext,
                                   with_targets=True))
        out.append(stack(frags, reset=True))
    return out


def stream_path(seed: int, n_frags: int, views: int, hw, n_vox: int, voxel_size: float,
                n_levels: int, scene_m: float, n_spheres: int, path_radius_m: float,
                device) -> List[Dict]:
    """A closed path of ``n_frags`` fragments through one scene of side
    ``scene_m`` metres: fragment k's window (n_vox voxels a side) is centred
    on the circle of ``path_radius_m`` around the scene's centre at angle
    2πk/n, its origin on the coarsest level's grid, and its views lie on an
    arc outside it, looking in."""
    H, W = hw
    ext = n_vox * voxel_size
    coarse = voxel_size * 2 ** (n_levels - 1)
    gen = torch.Generator(device=device).manual_seed(mix(seed, 1))
    floor_z = 0.1 * ext
    c = scene_m / 2
    rad = _uniform(gen, n_spheres, 0.0, 1.0, device).sqrt() * (path_radius_m + 1.4)
    ang = _uniform(gen, n_spheres, 0.0, 2 * math.pi, device)
    r = _uniform(gen, n_spheres, 0.25, 0.6, device)
    z = floor_z + _uniform(gen, n_spheres, 0.0, 1.0, device) * 0.9 + r
    spheres = torch.stack([c + rad * torch.cos(ang), c + rad * torch.sin(ang), z, r], -1).float()
    frags = []
    for k in range(n_frags):
        th = 2 * math.pi * k / n_frags
        cx, cy = c + path_radius_m * math.cos(th), c + path_radius_m * math.sin(th)
        ox = math.floor((cx - ext / 2) / coarse) * coarse
        oy = math.floor((cy - ext / 2) / coarse) * coarse
        origin = torch.tensor([ox, oy, 0.0], dtype=torch.float64, device=device)
        target = origin + torch.tensor([ext / 2, ext / 2, 0.35 * ext], dtype=torch.float64,
                                       device=device)
        eyes = _arc_eyes(target, 1.1 * ext, 0.45 * ext, th - 0.45 * math.pi, 0.9 * math.pi,
                         views)
        frags.append(stack([_fragment(spheres, floor_z, target, origin, eyes, H, W, n_vox,
                                      voxel_size, n_levels, 3.0 * ext, with_targets=False)],
                           reset=False))
    return frags
