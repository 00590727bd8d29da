"""Isosurface extraction from dense TSDF volumes on the host (the port's
copy of ``deep3dmap_tpu/core/utils/marching_cubes.py``).

*Marching tetrahedra*: each cube splits into 6 tetrahedra; each tet's
surface crossing is one of 2 non-trivial cases (1 or 2 triangles), so no
256-entry lookup tables are needed and the numpy version vectorizes over the
volume.  ``tsdf_to_mesh`` takes the C++ build (``ops/native.py``) when no
mask is given, as the JAX package does.
"""
from __future__ import annotations

import numpy as np

# 6 tetrahedra per cube, as indices into the cube's 8 corners
# corners: bit order (x, y, z): 0=(0,0,0) 1=(1,0,0) 2=(0,1,0) 3=(1,1,0)
#          4=(0,0,1) 5=(1,0,1) 6=(0,1,1) 7=(1,1,1)
_TETS = np.array([
    [0, 5, 1, 3],
    [0, 5, 3, 7],
    [0, 5, 7, 4],
    [0, 7, 3, 2],
    [0, 7, 2, 6],
    [0, 7, 6, 4],
], np.int64)

_CORNER_OFFSETS = np.array([
    [0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
    [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1],
], np.int64)


def _interp(p0, p1, v0, v1, level):
    t = (level - v0) / np.where(np.abs(v1 - v0) < 1e-12, 1e-12, v1 - v0)
    t = np.clip(t, 0.0, 1.0)[:, None]
    return p0 + t * (p1 - p0)


def marching_tetrahedra(vol: np.ndarray, level: float = 0.0,
                        mask: np.ndarray = None):
    """Extract the ``level`` isosurface of ``vol`` (X, Y, Z).

    Args:
        vol: scalar field; surface where vol crosses ``level``.
        mask: optional bool (X, Y, Z); cubes with any unmasked corner are
            skipped (e.g. weight>0 from TSDF fusion).

    Returns (verts (V, 3) float in voxel units, faces (F, 3) int).
    """
    X, Y, Z = vol.shape
    if X < 2 or Y < 2 or Z < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    # corner values for every cube: (Nc, 8)
    base = np.stack(np.meshgrid(np.arange(X - 1), np.arange(Y - 1),
                                np.arange(Z - 1), indexing="ij"),
                    axis=-1).reshape(-1, 3)
    corner_pos = base[:, None, :] + _CORNER_OFFSETS[None]  # (Nc, 8, 3)
    vals = vol[corner_pos[..., 0], corner_pos[..., 1], corner_pos[..., 2]]

    keep = ~np.all(vals > level, axis=1) & ~np.all(vals < level, axis=1)
    if mask is not None:
        mvals = mask[corner_pos[..., 0], corner_pos[..., 1], corner_pos[..., 2]]
        keep &= np.all(mvals, axis=1)
    vals = vals[keep]
    corner_pos = corner_pos[keep].astype(np.float64)
    if len(vals) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    tris = []
    for tet in _TETS:
        tv = vals[:, tet]          # (N, 4)
        tp = corner_pos[:, tet]    # (N, 4, 3)
        inside = tv < level        # (N, 4)
        n_in = inside.sum(1)

        # case: exactly one vertex inside (or outside) -> 1 triangle
        for flip in (False, True):
            ins = inside if not flip else ~inside
            sel = (ins.sum(1) == 1)
            if not sel.any():
                continue
            v, p = tv[sel], tp[sel]
            one = np.argmax(ins[sel], axis=1)
            others = np.array([[j for j in range(4) if j != i] for i in range(4)])
            oth = others[one]  # (M, 3)
            m = np.arange(sel.sum())
            p0 = p[m, one]
            v0 = v[m, one]
            e = [_interp(p0, p[m, oth[:, k]], v0, v[m, oth[:, k]], level)
                 for k in range(3)]
            tris.append(np.stack(e, axis=1))

        # case: two inside, two outside -> quad -> 2 triangles
        sel = n_in == 2
        if sel.any():
            v, p, ins = tv[sel], tp[sel], inside[sel]
            M = sel.sum()
            in_idx = np.argsort(~ins, axis=1)[:, :2]   # 2 inside
            out_idx = np.argsort(ins, axis=1)[:, :2]   # 2 outside
            m = np.arange(M)
            a, b = in_idx[:, 0], in_idx[:, 1]
            c, d = out_idx[:, 0], out_idx[:, 1]
            e_ac = _interp(p[m, a], p[m, c], v[m, a], v[m, c], level)
            e_ad = _interp(p[m, a], p[m, d], v[m, a], v[m, d], level)
            e_bc = _interp(p[m, b], p[m, c], v[m, b], v[m, c], level)
            e_bd = _interp(p[m, b], p[m, d], v[m, b], v[m, d], level)
            tris.append(np.stack([e_ac, e_ad, e_bc], axis=1))
            tris.append(np.stack([e_bc, e_ad, e_bd], axis=1))

    if not tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    tri_pts = np.concatenate(tris, axis=0)  # (F, 3, 3)

    # deduplicate vertices
    flat = tri_pts.reshape(-1, 3)
    key = np.round(flat * 1e5).astype(np.int64)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    verts = np.zeros((len(uniq), 3), np.float64)
    verts[inv] = flat
    faces = inv.reshape(-1, 3)
    # drop degenerate faces
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    return verts.astype(np.float32), faces[good]


def tsdf_to_mesh(tsdf: np.ndarray, origin=np.zeros(3), voxel_size: float = 1.0,
                 level: float = 0.0, mask: np.ndarray = None):
    """TSDF volume -> world-space mesh (native C++ path when available)."""
    if mask is None:
        from ...ops.native import marching_tets

        verts, faces = marching_tets(np.asarray(tsdf), level)
    else:
        verts, faces = marching_tetrahedra(np.asarray(tsdf), level=level, mask=mask)
    verts = verts * voxel_size + np.asarray(origin)[None]
    return verts.astype(np.float32), faces
