"""Mesh previews (port of ``deep3dmap_tpu/core/visualize/mesh_viewer.py``).

``save_mesh_preview`` renders a mesh through the host z-buffer rasterizer
(``ops/native.py::rasterize_mesh``) to an RGBA PNG, its pixels those of the
JAX package's ``plt.imsave`` (``floor(255 * clip(img, 0, 1))``, alpha 255),
written by the port's own PNG encoder (no matplotlib).  ``LiveMeshViewer``
refreshes a non-blocking open3d window where open3d is importable, and
otherwise, as in the JAX package, writes a PNG snapshot per refresh.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Optional

import numpy as np

from ...utils.image_io import imwrite_png


def _to_rgba8(img: np.ndarray) -> np.ndarray:
    rgb = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=-1)


def save_mesh_preview(verts: np.ndarray, faces: np.ndarray, save_path: str,
                      size: int = 512, elev_deg: float = 30.0,
                      azim_deg: float = 45.0) -> str:
    """A ``size``² shaded view of the mesh (centred, rotated by ``azim``
    about z then ``elev`` about x, coloured by height) as a PNG.  An empty
    mesh gives a blank image."""
    from ...ops.native import rasterize_mesh

    verts = np.asarray(verts, np.float64)
    if len(verts) == 0:
        imwrite_png(save_path, _to_rgba8(np.ones((size, size, 3), np.float32)))
        return save_path
    v = verts - verts.mean(0)
    a, e = np.deg2rad(azim_deg), np.deg2rad(elev_deg)
    Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    Rx = np.array([[1, 0, 0], [0, np.cos(e), -np.sin(e)], [0, np.sin(e), np.cos(e)]])
    v = v @ (Rx @ Rz).T
    extent = np.abs(v).max() + 1e-9
    px = (v[:, 0] / extent * 0.45 + 0.5) * (size - 1)
    py = (v[:, 1] / extent * 0.45 + 0.5) * (size - 1)
    pz = v[:, 2] - v[:, 2].min() + 1.0
    shade = (v[:, 2] - v[:, 2].min()) / (np.ptp(v[:, 2]) + 1e-9)
    colors = np.stack([0.3 + 0.7 * shade] * 3, -1).astype(np.float32)
    pv = np.stack([px, py, pz], -1).astype(np.float32)
    img, _ = rasterize_mesh(pv, np.asarray(faces, np.int64), colors, size, size)
    imwrite_png(save_path, _to_rgba8(img)[..., [2, 1, 0, 3]])    # the encoder takes BGRA
    return save_path


class LiveMeshViewer:
    """Incremental mesh preview during streaming inference: an open3d
    window when open3d is importable, else a PNG snapshot per ``update``
    under ``save_dir`` (``preview_0001.png``, ...)."""

    def __init__(self, save_dir: Optional[str] = None, window: bool = True, size: int = 512):
        self.save_dir = save_dir
        self.size = size
        self.n_updates = 0
        self._vis = None
        self._o3d = None
        self._geom = None
        if window:
            try:
                import open3d as o3d

                self._o3d = o3d
                self._vis = o3d.visualization.Visualizer()
                self._vis.create_window("deep3dmap", width=size, height=size, visible=True)
            except Exception:   # no open3d or no display: PNG snapshots
                self._vis = None
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)

    def update(self, verts: np.ndarray, faces: np.ndarray) -> Optional[str]:
        """Refresh with the current full mesh; the snapshot's path when
        running headless."""
        self.n_updates += 1
        if self._vis is not None:
            o3d = self._o3d
            mesh = o3d.geometry.TriangleMesh(
                o3d.utility.Vector3dVector(np.asarray(verts, np.float64)),
                o3d.utility.Vector3iVector(np.asarray(faces, np.int32)))
            mesh.compute_vertex_normals()
            if self._geom is not None:
                self._vis.remove_geometry(self._geom, reset_bounding_box=False)
            self._vis.add_geometry(mesh, reset_bounding_box=(self.n_updates == 1))
            self._geom = mesh
            self._vis.poll_events()
            self._vis.update_renderer()
            return None
        if self.save_dir:
            path = osp.join(self.save_dir, f"preview_{self.n_updates:04d}.png")
            return save_mesh_preview(np.asarray(verts), np.asarray(faces), path, size=self.size)
        return None

    def close(self):
        if self._vis is not None:
            self._vis.destroy_window()
            self._vis = None
