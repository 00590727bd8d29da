"""2D depth metrics (the port's copy of
``deep3dmap_tpu/core/evaluation/depth_eval.py``): AbsRel / AbsDiff / SqRel /
RMSE / LogRMSE / delta < 1.25^n / completeness."""
from __future__ import annotations

import numpy as np


def eval_depth(depth_pred: np.ndarray, depth_trgt: np.ndarray, max_depth: float = 10.0):
    mask1 = depth_pred > 0
    mask = (depth_trgt < max_depth) & (depth_trgt > 0) & mask1

    pred = depth_pred[mask]
    trgt = depth_trgt[mask]
    if pred.size == 0:
        return {k: float("nan") for k in
                ("AbsRel", "AbsDiff", "SqRel", "RMSE", "LogRMSE", "r1", "r2", "r3")} | {
                    "complete": 0.0}

    abs_diff = np.abs(pred - trgt)
    abs_rel = abs_diff / trgt
    sq_diff = abs_diff ** 2
    sq_rel = sq_diff / trgt
    sq_log_diff = (np.log(pred) - np.log(trgt)) ** 2
    thresh = np.maximum(trgt / pred, pred / trgt)

    return {
        "AbsRel": float(np.mean(abs_rel)),
        "AbsDiff": float(np.mean(abs_diff)),
        "SqRel": float(np.mean(sq_rel)),
        "RMSE": float(np.sqrt(np.mean(sq_diff))),
        "LogRMSE": float(np.sqrt(np.mean(sq_log_diff))),
        "r1": float(np.mean(thresh < 1.25)),
        "r2": float(np.mean(thresh < 1.25 ** 2)),
        "r3": float(np.mean(thresh < 1.25 ** 3)),
        "complete": float(np.mean(mask1.astype(np.float64))),
    }
