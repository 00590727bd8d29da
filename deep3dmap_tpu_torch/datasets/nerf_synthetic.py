"""Synthetic posed images for GNeRF (port of
``deep3dmap_tpu/datasets/nerf_synthetic.py``): ``n_images`` views on a
circle around the SDF scene of ``datasets/synthetic.py``, sphere-traced on
the host (``render_nerf_view``).  The same arguments give the JAX reader's
images.  Items: ``imgs`` (H, W, 3) in [-1, 1] and ``img_idx``."""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..utils.device import resolve_device
from .builder import DATASETS
from .synthetic import NERF_SPHERES, circle_eye, look_at_pose, render_nerf_view


@DATASETS.register_module()
class SyntheticNerfDataset:
    """``color_mode``: ``"shade"`` colours by camera distance (view
    dependent), ``"position"`` by the world position of the surface point
    (photo-consistent across views, what pose recovery needs).  The items
    are host arrays; ``device`` is resolved as every entry point's (CUDA
    unless ``"cpu"``; raises without a GPU), as ``BlenderDataset``'s."""

    name = "synthetic_nerf"

    def __init__(self, n_images: int = 8, img_wh=(64, 64), radius: float = 2.0,
                 elev_deg: float = 30.0, seed: int = 0, split: str = "train",
                 color_mode: str = "shade", pipeline=None, device=None):
        self.device = resolve_device(device)
        self.n_images = n_images
        self.img_wh = tuple(img_wh)
        W, H = self.img_wh
        self.intrinsics = np.array([[W, 0, W / 2], [0, W, H / 2], [0, 0, 1]], np.float32)
        rs = np.random.RandomState(seed)
        offset = rs.uniform(0, 2 * np.pi) if split == "val" else 0.0
        self.images, self.poses = [], []
        for i in range(n_images):
            eye = circle_eye(radius, elev_deg, 2 * np.pi * i / n_images + offset)
            pose = look_at_pose(eye, np.zeros(3, np.float32))
            img, _ = render_nerf_view(self.intrinsics, pose, H, W, NERF_SPHERES, radius,
                                      color_mode)
            self.images.append(img * 2.0 - 1.0)
            self.poses.append(pose)

    def __len__(self):
        return self.n_images

    def __getitem__(self, idx: int) -> Dict:
        return dict(imgs=self.images[idx], img_idx=np.int32(idx))
