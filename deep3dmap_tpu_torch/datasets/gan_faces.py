"""Synthetic Gan2Shape instance dataset (the port's own copy).

Copy of ``deep3dmap_tpu/datasets/gan_faces.py::SyntheticGanFaceDataset``,
numpy only like the original, so the two packages make the same inputs from
one seed.  Pull-model ``setup_input(idx)`` returns one image instance with
its StyleGAN w latent: images are shaded sphere renders (face-like smooth
depth) in [-1, 1], NHWC, and latents fixed random vectors.  Registered in
``DATASETS`` as in JAX, so ``configs/gan2shape/celeba_synthetic.py`` builds
through the CLIs; ``device`` is the keyword they pass every dataset (the
items are host arrays).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .builder import DATASETS


@DATASETS.register_module()
class SyntheticGanFaceDataset:
    def __init__(self, n_samples: int = 4, image_size: int = 64, z_dim: int = 128,
                 n_latent: int = 8, seed: int = 0, pipeline=None, device=None):
        self.n_samples = n_samples
        self.image_size = image_size
        self.z_dim = z_dim
        self.n_latent = n_latent
        self.seed = seed
        self._cache: Dict[int, Dict] = {}

    def __len__(self):
        return self.n_samples

    def _make(self, idx):
        rs = np.random.RandomState(self.seed + idx)
        S = self.image_size
        yy, xx = np.meshgrid(np.linspace(-1, 1, S), np.linspace(-1, 1, S),
                             indexing="ij")
        cx, cy = rs.uniform(-0.2, 0.2, 2)
        r2 = (xx - cx) ** 2 + (yy - cy) ** 2
        z = np.sqrt(np.clip(0.8 - r2, 0, None))
        lx, ly = rs.uniform(-0.5, 0.5, 2)
        shade = np.clip(z + lx * (xx - cx) + ly * (yy - cy), 0, 1)
        tint = rs.uniform(0.5, 1.0, 3)
        img = (shade[..., None] * tint[None, None]) * 2 - 1
        # w-space latent (1 vector; the generator broadcasts to w+)
        latent_w = rs.randn(self.z_dim).astype(np.float32) * 0.1
        return dict(input_im=img.astype(np.float32), latent_w=latent_w)

    def setup_input(self, idx: int) -> Dict:
        """Batched single instance (a leading axis of 1)."""
        s = self[idx % len(self)]
        return {k: np.asarray(v)[None] for k, v in s.items()}

    def __getitem__(self, idx):
        if idx not in self._cache:
            self._cache[idx] = self._make(idx)
        return self._cache[idx]
