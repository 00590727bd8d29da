"""One scene of the ScanNet mesh evaluation, run in a worker process (port of
``deep3dmap_tpu/datasets/scannet.py::_eval_one_scene``).

The predicted mesh is rendered to depth at the GT poses of every tenth frame
with the host rasterizer (``ops/native.py``) and scored with the depth
metrics, then sampled against the GT mesh's vertices for the F-score.  The
module imports numpy, scipy and the port's host modules only: a worker never
imports torch, so it can hold no CUDA context.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Dict, List

import numpy as np

from ...ops import native
from ...utils.image_io import imread
from ..utils.io_ply import read_ply
from .depth_eval import eval_depth
from .mesh_eval import eval_fscore_points


def read_matrix(path: str) -> np.ndarray:
    return np.loadtxt(path).astype(np.float32)


def eval_one_scene(job) -> Dict[str, float]:
    """``job`` = (scene, mesh_path, scene_dir, max_depth); returns the
    scene's depth metrics (means over the frames) and F-score metrics."""
    scene, mesh_path, scene_dir, max_depth = job
    verts, faces = read_ply(mesh_path)

    pose_dir = osp.join(scene_dir, "pose")
    depth_dir = osp.join(scene_dir, "depth")
    intr = read_matrix(osp.join(scene_dir, "intrinsic", "intrinsic_depth.txt"))[:3, :3]
    frame_ids = sorted(int(f[:-4]) for f in os.listdir(depth_dir))[::10]

    depth_metrics: List[Dict[str, float]] = []
    for fid in frame_ids:
        gt_depth = imread(osp.join(depth_dir, f"{fid}.png")).astype(np.float32) / 1000.0
        pose = read_matrix(osp.join(pose_dir, f"{fid}.txt"))
        w2c = np.linalg.inv(pose)
        cam = verts @ w2c[:3, :3].T + w2c[:3, 3]
        z = cam[:, 2:3]
        pix = (cam / np.maximum(z, 1e-6)) @ intr.T
        pv = np.concatenate([pix[:, :2], cam[:, 2:3]], 1).astype(np.float32)
        h, w = gt_depth.shape
        rendered = native.render_depth(pv, faces, h, w)
        depth_metrics.append(eval_depth(rendered, gt_depth, max_depth=max_depth))

    out = {}
    if depth_metrics:
        for k in depth_metrics[0]:
            out[k] = float(np.mean([m[k] for m in depth_metrics]))

    gt_mesh = osp.join(scene_dir, f"{scene}_vh_clean_2.ply")
    if osp.exists(gt_mesh):
        gt_verts, _ = read_ply(gt_mesh)
        out.update(eval_fscore_points(verts, gt_verts))
    return out
