"""Synthetic face-UV pairs for PRNet, with NME ``evaluate`` (port of
``deep3dmap_tpu/datasets/face_uv.py``; numpy, so both packages make the same
items from one seed).  ``device`` is the keyword the CLIs pass every
dataset; the items are host arrays."""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.evaluation.face_eval import eval_nme
from .builder import DATASETS


@DATASETS.register_module()
class SyntheticFaceUVDataset:
    def __init__(self, n_samples: int = 16, resolution: int = 64, seed: int = 0,
                 pipeline=None, device=None):
        self.n_samples = n_samples
        self.resolution = resolution
        self.seed = seed
        # a fixed smooth image -> position map mapping, so the task is learnable
        self._mix = np.random.RandomState(seed + 7).rand(3, 3).astype(np.float32)
        self._cache: Dict[int, Dict] = {}

    def __len__(self):
        return self.n_samples

    def _make(self, idx):
        rs = np.random.RandomState(self.seed + idx)
        S = self.resolution
        img = rs.rand(S, S, 3).astype(np.float32)
        uv = np.clip(img @ self._mix, 0, 1).astype(np.float32)
        return dict(faceimg=img, gt_uvimg=uv, tform_mat=np.eye(3, dtype=np.float32),
                    gt_kpt_proj2d=np.zeros((2, 68), np.float32))

    def __getitem__(self, idx):
        if idx not in self._cache:
            self._cache[idx] = self._make(idx)
        return self._cache[idx]

    def evaluate(self, results, metric="nme", **kwargs):
        """results: ``{"kpt": [(B, 3, 68), ...]}`` (``tools/test.py``'s
        collection); the ground truth is the GT map read at the synthetic
        BFM's landmark texels, as ``FaceImg2UV`` reads its prediction."""
        if metric not in ("nme", "rmse"):
            raise KeyError(f"metric {metric} is not supported")
        from ..models.frameworks.prnet import uv_kpt_ind_from_bfm

        kpt = np.concatenate(results["kpt"], axis=0)
        n = min(kpt.shape[0], len(self))
        ind = uv_kpt_ind_from_bfm(None, self.resolution)
        tforms = np.stack([self[i]["tform_mat"] for i in range(n)])
        gt = np.stack([self[i]["gt_uvimg"][ind[1], ind[0], :2].T * 255.0 for i in range(n)])
        return {"nme": eval_nme(kpt[:n], tforms, gt)}
