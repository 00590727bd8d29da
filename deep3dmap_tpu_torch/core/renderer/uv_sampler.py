"""UV-space texture sampling (port of
``deep3dmap_tpu/core/renderer/uv_sampler.py``).

The template's UV layout is fixed, so its rasterization (a triangle id and
barycentric weights per texel) is computed once on the host in numpy
(``precompute_uv_rasterization``, the port's own copy of JAX's :33-74).  A
step then runs gathers and the bilinear ``grid_sample_2d_batch`` only:

    texel colour = bilinear(img, sum_k bary_k * face_project[tri_vert_k])
    texel mask   = any vertex of the texel's triangle visible, and covered

Texels no triangle covers (``tri_id == -1``) gather triangle 0 and are
masked afterwards, as in JAX.  The gradient reaches ``face_project`` only
through the bilinear weights of the sampler; the masks are booleans.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...ops.grid_sample import grid_sample_2d_batch
from ...utils.device import DeviceLike, resolve_device
from ..all3dtrans.rotations import euler_angles_to_matrix


class UVRasterization(NamedTuple):
    tri_id: torch.Tensor     # (S, S) int64, -1 where empty
    bary: torch.Tensor       # (S, S, 3) float32
    tri_verts: torch.Tensor  # (T, 3) int64 vertex ids per triangle


def _cross2(u, v):
    return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]


def precompute_uv_rasterization(uvs: np.ndarray, triangles: np.ndarray, tex_size: int,
                                device: DeviceLike = None) -> UVRasterization:
    """Rasterize the template's UV triangles onto a ``tex_size``² grid on the
    host; a later triangle overwrites an earlier one.  ``uvs`` (N, 2) in
    [0, 1], ``triangles`` (T, 3).  The tables go to ``device`` (CUDA unless
    ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    uvs = np.asarray(uvs, np.float64)
    triangles = np.asarray(triangles, np.int64)
    S = tex_size
    tri_id = np.full((S, S), -1, np.int64)
    bary = np.zeros((S, S, 3), np.float32)
    pix = uvs * (S - 1)
    for t, (a, b, c) in enumerate(triangles):
        pa, pb, pc = pix[a], pix[b], pix[c]
        xmin = max(int(np.floor(min(pa[0], pb[0], pc[0]))), 0)
        xmax = min(int(np.ceil(max(pa[0], pb[0], pc[0]))), S - 1)
        ymin = max(int(np.floor(min(pa[1], pb[1], pc[1]))), 0)
        ymax = min(int(np.ceil(max(pa[1], pb[1], pc[1]))), S - 1)
        if xmax < xmin or ymax < ymin:
            continue
        d = _cross2(pb - pa, pc - pa)
        if abs(d) < 1e-12:
            continue
        xs, ys = np.meshgrid(np.arange(xmin, xmax + 1), np.arange(ymin, ymax + 1))
        p = np.stack([xs, ys], axis=-1).astype(np.float64)
        w0 = _cross2(pb - p, pc - p) / d
        w1 = _cross2(pc - p, pa - p) / d
        w2 = 1.0 - w0 - w1
        inside = (w0 >= -1e-9) & (w1 >= -1e-9) & (w2 >= -1e-9)
        yy, xx = ys[inside], xs[inside]
        tri_id[yy, xx] = t
        bary[yy, xx] = np.stack([w0[inside], w1[inside], w2[inside]], axis=-1)
    return UVRasterization(tri_id=torch.from_numpy(tri_id).to(dev),
                           bary=torch.from_numpy(bary).to(dev),
                           tri_verts=torch.from_numpy(triangles).to(dev))


def vertex_visibility(normals: torch.Tensor, angles: torch.Tensor,
                      lookview: torch.Tensor) -> torch.Tensor:
    """(B, N) bool: the rotated normal faces ``lookview`` (dot >= 0).
    normals (N, 3), angles (B, 3), lookview (3,)."""
    R = euler_angles_to_matrix(angles, "XYZ")
    n_rot = torch.einsum("nj,bij->bni", normals, R)
    return (n_rot * lookview[None, None]).sum(-1) >= 0


def sample_uv_texture(rast: UVRasterization, imgs: torch.Tensor,
                      face_project: torch.Tensor, ver_visible: torch.Tensor):
    """Per-texel colours of ``imgs`` (B, H, W, C) at the projected vertex
    positions ``face_project`` (B, N, 2) in [0, 1] image units (y flipped
    as in the framework), masked by ``ver_visible`` (B, N) bool.  Returns
    (uvimg (B, S, S, C), uvmask (B, S, S, 1))."""
    B, H, W, C = imgs.shape
    S = rast.tri_id.shape[0]
    tv = rast.tri_verts[torch.clamp(rast.tri_id, min=0)]        # (S, S, 3)
    covered = rast.tri_id >= 0
    uv = (rast.bary[None, ..., None] * face_project[:, tv]).sum(dim=3)   # (B, S, S, 2)
    px = (uv[..., 0] * (W - 1)).reshape(B, -1)
    py = (uv[..., 1] * (H - 1)).reshape(B, -1)
    colors = grid_sample_2d_batch(imgs, px, py).reshape(B, S, S, C)
    mask = (ver_visible[:, tv].any(dim=-1) & covered).to(imgs.dtype)[..., None]
    return colors * mask, mask
