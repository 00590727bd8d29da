"""Mesh/point-cloud F-score by nearest-neighbour correspondence (the port's
copy of ``deep3dmap_tpu/core/evaluation/mesh_eval.py``): scipy ``cKDTree``,
voxel downsampling with ``np.unique``."""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Average points within voxels of side ``voxel`` (open3d-equivalent)."""
    if len(points) == 0 or voxel is None or voxel <= 0:
        return points
    keys = np.floor(points / voxel).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((counts.size, 3), np.float64)
    np.add.at(sums, inv, points)
    return (sums / counts[:, None]).astype(points.dtype)


def nn_correspondance(verts1: np.ndarray, verts2: np.ndarray):
    """For each vertex in verts2, nearest vertex in verts1.
    Returns (indices, distances)."""
    if len(verts1) == 0 or len(verts2) == 0:
        return np.array([], np.int64), np.array([], np.float64)
    tree = cKDTree(verts1)
    distances, indices = tree.query(verts2, k=1)
    return indices, distances


def eval_fscore_points(verts_pred: np.ndarray, verts_trgt: np.ndarray,
                       threshold: float = 0.05, down_sample: float = 0.02):
    """F-score between two point sets (same metric names as the reference)."""
    if down_sample:
        verts_pred = voxel_downsample(np.asarray(verts_pred, np.float64), down_sample)
        verts_trgt = voxel_downsample(np.asarray(verts_trgt, np.float64), down_sample)

    _, dist1 = nn_correspondance(verts_pred, verts_trgt)  # trgt -> pred
    _, dist2 = nn_correspondance(verts_trgt, verts_pred)  # pred -> trgt

    precision = float(np.mean(dist2 < threshold)) if len(dist2) else 0.0
    recall = float(np.mean(dist1 < threshold)) if len(dist1) else 0.0
    fscore = 2 * precision * recall / max(precision + recall, 1e-12)
    return {
        "dist1": float(np.mean(dist2)) if len(dist2) else float("inf"),
        "dist2": float(np.mean(dist1)) if len(dist1) else float("inf"),
        "prec": precision,
        "recal": recall,
        "fscore": fscore,
    }
