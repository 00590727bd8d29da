"""Host-side global scene TSDF assembly and mesh export (the port's copy of
``deep3dmap_tpu/core/utils/scene_assembler.py``).

Per-fragment predicted TSDF windows replace voxels of a growing host-side
scene volume (direct substitution); meshes are extracted on a scene change
or on demand.  The device keeps only the fixed-size recurrent state; the
scene's unbounded growth lives here in numpy.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Dict, Optional

import numpy as np

from .io_ply import write_ply
from .marching_cubes import tsdf_to_mesh


class _SceneVolume:
    def __init__(self, voxel_size: float):
        self.voxel_size = voxel_size
        self.tsdf: Optional[np.ndarray] = None
        self.origin_vox: Optional[np.ndarray] = None  # voxel coords of tsdf[0,0,0]

    def _ensure(self, lo_vox: np.ndarray, hi_vox: np.ndarray):
        if self.tsdf is None:
            shape = hi_vox - lo_vox
            self.tsdf = np.ones(shape, np.float32)
            self.origin_vox = lo_vox.copy()
            return
        new_lo = np.minimum(self.origin_vox, lo_vox)
        new_hi = np.maximum(self.origin_vox + np.array(self.tsdf.shape), hi_vox)
        if (new_lo == self.origin_vox).all() and \
           (new_hi == self.origin_vox + np.array(self.tsdf.shape)).all():
            return
        new = np.ones(new_hi - new_lo, np.float32)
        off = self.origin_vox - new_lo
        s = self.tsdf.shape
        new[off[0]:off[0] + s[0], off[1]:off[1] + s[1], off[2]:off[2] + s[2]] = self.tsdf
        self.tsdf = new
        self.origin_vox = new_lo

    def substitute(self, tsdf_window: np.ndarray, origin_world: np.ndarray,
                   occupied: Optional[np.ndarray] = None):
        """Replace window voxels (direct_substitute semantics,
        gru_fusion.py:122-150)."""
        lo = np.round(origin_world / self.voxel_size).astype(np.int64)
        hi = lo + np.array(tsdf_window.shape)
        self._ensure(lo, hi)
        off = lo - self.origin_vox
        sl = tuple(slice(off[i], off[i] + tsdf_window.shape[i]) for i in range(3))
        if occupied is None:
            self.tsdf[sl] = tsdf_window
        else:
            region = self.tsdf[sl]
            region[occupied] = tsdf_window[occupied]
            self.tsdf[sl] = region

    @property
    def origin_world(self):
        return self.origin_vox * self.voxel_size


class SceneAssembler:
    def __init__(self, voxel_size: float = 0.04, save_dir: Optional[str] = None):
        self.voxel_size = voxel_size
        self.save_dir = save_dir
        self.scenes: Dict[str, _SceneVolume] = {}
        self.current_scene: Optional[str] = None

    def update(self, scene: str, tsdf_window: np.ndarray, origin_world: np.ndarray,
               occupied: Optional[np.ndarray] = None):
        """Integrate one fragment's prediction. Returns the name of a scene
        that was finalized (changed away from), if any."""
        finalized = None
        if self.current_scene is not None and scene != self.current_scene:
            finalized = self.current_scene
            if self.save_dir:
                self.save_mesh(finalized)
        self.current_scene = scene
        if scene not in self.scenes:
            self.scenes[scene] = _SceneVolume(self.voxel_size)
        self.scenes[scene].substitute(np.asarray(tsdf_window),
                                      np.asarray(origin_world), occupied)
        return finalized

    def get_mesh(self, scene: str):
        vol = self.scenes[scene]
        return tsdf_to_mesh(vol.tsdf, origin=vol.origin_world,
                            voxel_size=self.voxel_size)

    def save_mesh(self, scene: str) -> str:
        os.makedirs(self.save_dir, exist_ok=True)
        verts, faces = self.get_mesh(scene)
        path = osp.join(self.save_dir, f"{scene}.ply")
        write_ply(path, verts, faces)
        return path

    def save_all(self):
        return [self.save_mesh(s) for s in self.scenes]
