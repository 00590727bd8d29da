"""Face landmark NME (port of ``deep3dmap_tpu/core/evaluation/face_eval.py``):
the keypoints read from the predicted UV position map, mapped back through
the inverse crop transform, their mean error normalised by sqrt(w * h) of
the ground truth's bounding box.  Host numpy."""
from __future__ import annotations

import numpy as np


def eval_nme(kpt_pred_uv: np.ndarray, tform_mats: np.ndarray,
             gt_kpt_proj2d: np.ndarray, uv_scale: float = 255.0) -> float:
    """kpt_pred_uv (N, 3 or 2, 68) in UV-map units [0, 1]; tform_mats
    (N, 3, 3) crop transforms (original -> crop); gt_kpt_proj2d (N, 2, 68)
    in original image space."""
    kpt68 = kpt_pred_uv[:, :2, :] * uv_scale
    nmes = []
    for j in range(kpt68.shape[0]):
        cropped = np.vstack([kpt68[j], np.ones((1, 68))])
        pred2d = (np.linalg.inv(tform_mats[j]) @ cropped)[:2, :].T    # (68, 2)
        gt2d = gt_kpt_proj2d[j].T
        w = abs(gt2d[:, 0].max() - gt2d[:, 0].min())
        h = abs(gt2d[:, 1].max() - gt2d[:, 1].min())
        err = np.sqrt(((gt2d - pred2d) ** 2).sum(axis=1)).mean()
        nmes.append(err / np.sqrt(max(w * h, 1e-12)))
    return float(np.mean(nmes))
