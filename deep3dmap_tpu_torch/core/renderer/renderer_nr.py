"""Grid-mesh depth renderer (port of ``deep3dmap_tpu/core/renderer/renderer_nr.py``).

Pinhole unprojection of depth maps, rigid view warping (rotation about a
canonical center, then translation), depth re-rendering under a new view,
normals from depth, view-warped image resampling and yaw sweeps.  The warped
depth is rendered by softmax-z-buffer splatting (``raster_mode="splat"``,
the default) or by the hard z-buffer triangle rasterizer
(``raster_mode="hard"``: the CUDA kernel of ``ops/raster.py`` on the card,
with straight-through splat gradients).

Layouts as in the JAX package: depth (B, H, W), images (B, H, W, C), points
(B, H, W, 3), views (B, 6).  K and inv_K are float32, built on the CPU and
moved to ``device``, so the CPU and the card use the same bits.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ...ops.grid_sample import grid_sample_2d_batch
from ...ops.raster import raster_depth_st, splat_depth_soft
from ...utils.device import DeviceLike, resolve_device

EPS = 1e-7


def get_grid(b: int, H: int, W: int, normalize: bool = True,
             device=None) -> torch.Tensor:
    """(b, H, W, 2) pixel grid in (x, y) order (renderer utils get_grid)."""
    if normalize:
        h_range = torch.linspace(-1, 1, H, device=device)
        w_range = torch.linspace(-1, 1, W, device=device)
    else:
        h_range = torch.arange(0, H, dtype=torch.float32, device=device)
        w_range = torch.arange(0, W, dtype=torch.float32, device=device)
    hh, ww = torch.meshgrid(h_range, w_range, indexing="ij")
    grid = torch.stack([ww, hh], -1)  # flip (h,w) -> (x,y)
    return grid[None].expand(b, H, W, 2)


def get_rotation_matrix(tx, ty, tz) -> torch.Tensor:
    """Batched R = Rz @ Ry @ Rx from per-axis angles (renderer utils)."""
    zeros = torch.zeros_like(tx)
    ones = torch.ones_like(tx)
    m_x = torch.stack([ones, zeros, zeros,
                       zeros, torch.cos(tx), -torch.sin(tx),
                       zeros, torch.sin(tx), torch.cos(tx)], -1).reshape(-1, 3, 3)
    m_y = torch.stack([torch.cos(ty), zeros, torch.sin(ty),
                       zeros, ones, zeros,
                       -torch.sin(ty), zeros, torch.cos(ty)], -1).reshape(-1, 3, 3)
    m_z = torch.stack([torch.cos(tz), -torch.sin(tz), zeros,
                       torch.sin(tz), torch.cos(tz), zeros,
                       zeros, zeros, ones], -1).reshape(-1, 3, 3)
    return m_z @ m_y @ m_x


def get_transform_matrices(view: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """view (B, 6|5|3): rx, ry, rz[, tx, ty[, tz]] -> (R (B,3,3), t (B,1,3))."""
    b = view.shape[0]
    rx, ry, rz = view[:, 0], view[:, 1], view[:, 2]
    if view.shape[1] == 6:
        trans_xyz = view[:, 3:].reshape(b, 1, 3)
    elif view.shape[1] == 5:
        trans_xyz = torch.cat([view[:, 3:].reshape(b, 1, 2),
                               view.new_zeros((b, 1, 1))], 2)
    else:
        trans_xyz = view.new_zeros((b, 1, 3))
    return get_rotation_matrix(rx, ry, rz), trans_xyz


class NrRenderer:
    """Renderer configuration plus pure tensor methods; ``device`` holds K
    (``None``: the GPU, raising without one; ``"cpu"`` by name)."""

    def __init__(self, cfgs: dict, image_size: int, device: DeviceLike = None):
        self.image_size = image_size
        self.device = resolve_device(device)
        self.min_depth = cfgs.get("min_depth", 0.9)
        self.max_depth = cfgs.get("max_depth", 1.1)
        self.rot_center_depth = cfgs.get(
            "rot_center_depth", (self.min_depth + self.max_depth) / 2)
        self.fov = cfgs.get("fov", 10)
        self.splat_beta = cfgs.get("splat_beta", 20.0)
        self.raster_mode = cfgs.get("raster_mode", "splat")  # or "hard"
        if self.raster_mode not in ("splat", "hard"):
            raise ValueError(f"NrRenderer: unknown raster_mode {self.raster_mode!r}")

        fx = (image_size - 1) / 2 / math.tan(self.fov / 2 * math.pi / 180)
        cx = (image_size - 1) / 2
        K = torch.tensor([[fx, 0.0, cx], [0.0, fx, cx], [0.0, 0.0, 1.0]],
                         dtype=torch.float32)
        self.K_origin = K
        self._set_K(K)
        # constants built once on the device: a tensor made from a Python
        # list inside a step would copy from the host and wait for it
        self._centroid = torch.tensor([0.0, 0.0, self.rot_center_depth],
                                      device=self.device).reshape(1, 1, 3)
        self._z_axis = torch.tensor([0.0, 0.0, 1.0], device=self.device)

    def _set_K(self, K: torch.Tensor):
        self.K = K.to(self.device)
        self.inv_K = torch.linalg.inv(K).to(self.device)   # on the CPU

    def downscale_K(self, downscale: float):
        if downscale > 1:
            K = self.K_origin.clone()
            K[:2] = K[:2] * (1.0 / downscale)
            self._set_K(K)

    # -- geometry ----------------------------------------------------------
    def rotate_pts(self, pts, rot_mat):
        return ((pts - self._centroid) @ rot_mat.transpose(-1, -2)
                + self._centroid)

    def translate_pts(self, pts, trans_xyz):
        return pts + trans_xyz

    def depth_to_3d_grid(self, depth):
        """depth (B, H, W) -> camera-space points (B, H, W, 3)."""
        b, h, w = depth.shape
        grid_2d = get_grid(b, h, w, normalize=False, device=depth.device)
        grid_3d = torch.cat([grid_2d, grid_2d.new_ones((b, h, w, 1))], -1)
        return (grid_3d @ self.inv_K.T) * depth[..., None]

    def grid_3d_to_2d(self, grid_3d):
        """(B,H,W,3) -> normalized [-1,1] pixel coords (B,H,W,2)."""
        b, h, w, _ = grid_3d.shape
        grid_2d = grid_3d / torch.clamp(grid_3d[..., 2:], min=EPS)
        grid_2d = (grid_2d @ self.K.T)[..., :2]
        grid_2d = torch.stack([grid_2d[..., 0] / (w - 1),
                               grid_2d[..., 1] / (h - 1)], -1)
        return grid_2d * 2.0 - 1.0

    def get_warped_3d_grid(self, depth, rot_mat, trans_xyz):
        b, h, w = depth.shape
        g = self.depth_to_3d_grid(depth).reshape(b, -1, 3)
        g = self.rotate_pts(g, rot_mat)
        g = self.translate_pts(g, trans_xyz)
        return g.reshape(b, h, w, 3)

    def get_inv_warped_3d_grid(self, depth, rot_mat, trans_xyz):
        b, h, w = depth.shape
        g = self.depth_to_3d_grid(depth).reshape(b, -1, 3)
        g = self.translate_pts(g, -trans_xyz)
        g = self.rotate_pts(g, rot_mat.transpose(-1, -2))
        return g.reshape(b, h, w, 3)

    def get_warped_2d_grid(self, depth, rot_mat, trans_xyz):
        return self.grid_3d_to_2d(self.get_warped_3d_grid(depth, rot_mat, trans_xyz))

    def get_inv_warped_2d_grid(self, depth, rot_mat, trans_xyz):
        return self.grid_3d_to_2d(self.get_inv_warped_3d_grid(depth, rot_mat, trans_xyz))

    # -- depth rendering ---------------------------------------------------
    def splat_depth(self, points3d):
        """Warped 3D pixels (B, H, W, 3) -> target-view depth map by
        softmax-z-buffer bilinear splatting."""
        return splat_depth_soft(points3d, self.K, self.min_depth,
                                self.max_depth, self.splat_beta)

    def raster_depth(self, points3d):
        """Hard z-buffer triangle rasterization (the CUDA kernel on the card,
        its plain version on the CPU) with straight-through gradients."""
        return raster_depth_st(points3d, self.K, self.min_depth,
                               self.max_depth, self.splat_beta)

    def warp_canon_depth(self, canon_depth, rot_mat, trans_xyz):
        """Canonical depth -> depth seen from the transformed view."""
        warped_pts = self.get_warped_3d_grid(canon_depth, rot_mat, trans_xyz)
        if self.raster_mode == "hard":
            warped_depth = self.raster_depth(warped_pts)
        else:
            warped_depth = self.splat_depth(warped_pts)
        margin = (self.max_depth - self.min_depth) / 2
        return torch.clamp(warped_depth, self.min_depth - margin,
                           self.max_depth + margin)

    # -- normals -----------------------------------------------------------
    def get_normal_from_depth(self, depth):
        b, h, w = depth.shape
        g = self.depth_to_3d_grid(depth)
        tu = g[:, 1:-1, 2:] - g[:, 1:-1, :-2]
        tv = g[:, 2:, 1:-1] - g[:, :-2, 1:-1]
        normal = torch.linalg.cross(tu, tv, dim=-1)
        zero = self._z_axis.expand(b, h - 2, 1, 3)
        normal = torch.cat([zero, normal, zero], 2)
        zero_row = self._z_axis.expand(b, 1, w, 3)
        normal = torch.cat([zero_row, normal, zero_row], 1)
        return normal / (torch.linalg.norm(normal, dim=-1, keepdim=True) + EPS)

    # -- image warping -----------------------------------------------------
    def _grid_sample_images(self, im, grid2d, mode="bilinear"):
        """im (B, H, W, C); grid2d (B, H, W, 2) in [-1,1]."""
        B, H, W, C = im.shape
        px = (grid2d[..., 0] + 1) * 0.5 * (W - 1)
        py = (grid2d[..., 1] + 1) * 0.5 * (H - 1)
        return grid_sample_2d_batch(im, px.reshape(B, -1), py.reshape(B, -1),
                                    mode=mode).reshape(B, H, W, C)

    def render_given_view(self, im, depth, view, mask: Optional[torch.Tensor] = None):
        """Resample ``im`` as seen after applying ``view`` to the canonical
        depth (grid_sample path)."""
        rot_mat, trans_xyz = get_transform_matrices(view)
        recon_depth = self.warp_canon_depth(depth, rot_mat, trans_xyz)
        grid2d = self.get_inv_warped_2d_grid(recon_depth, rot_mat, trans_xyz)
        warped = self._grid_sample_images(im, grid2d)
        if mask is not None:
            warped_mask = self._grid_sample_images(mask, grid2d, mode="nearest")
            return warped, warped_mask
        return warped

    def render_yaw(self, im, depth, v_before=None, maxr: float = 90,
                   nsample: int = 9):
        """Yaw sweep for visualization.  Returns (B, nsample, H, W, C)."""
        outs = []
        for ri in torch.linspace(-math.pi / 180 * maxr, math.pi / 180 * maxr,
                                 nsample):
            view = im.new_tensor([0.0, float(ri), 0, 0, 0, 0]).reshape(1, 6)
            view = view.expand(im.shape[0], 6)
            if v_before is not None:
                view = view - v_before
            outs.append(self.render_given_view(im, depth, view))
        return torch.stack(outs, 1)
