"""ScanNet fragment dataset and its mesh evaluation (port of
``deep3dmap_tpu/datasets/scannet.py``).

Samples are keyframe windows listed in ``fragments_<mode>.pkl`` (written by
``tools/data_gen_scannet.py``), read frame by frame through
``utils/image_io.py``.  ``evaluate`` scores saved scene meshes in a pool of
``spawn`` processes, one scene each (``core/evaluation/scene_eval.py``,
which imports no torch); a single scene, or ``n_proc`` 1, is scored in the
calling process.
"""
from __future__ import annotations

import os.path as osp
import pickle
from multiprocessing import get_context
from typing import Dict, List, Optional

import numpy as np

from ..core.evaluation.scene_eval import eval_one_scene, read_matrix
from ..utils.image_io import imread
from .builder import DATASETS
from .pipelines.compose import Compose


@DATASETS.register_module()
class ScanNetDataset:
    """Expects the standard exported layout:

    datapath/
      scans[_test]/<scene>/color/<i>.jpg  depth/<i>.png  pose/<i>.txt
                           intrinsic/intrinsic_depth.txt
      fragments_<mode>.pkl

    ``device`` goes to the pipeline's transforms that take one (the GT
    fusion); it is the card unless the caller asks for the CPU.
    """

    def __init__(self, datapath: str, mode: str = "train", nviews: int = 9,
                 n_scales: int = 2, img_size=(640, 480), n_vox: int = 96,
                 voxel_size: float = 0.04, epoch: int = 0, pipeline=None,
                 device=None):
        self.datapath = datapath
        self.mode = mode
        self.nviews = nviews
        self.n_scales = n_scales
        self.img_size = tuple(img_size)
        self.n_vox = n_vox
        self.voxel_size = voxel_size
        self.epoch = epoch
        self.pipeline = Compose(pipeline, device=device) if pipeline else None

        frag_path = osp.join(datapath, f"fragments_{mode.replace('_debug', '')}.pkl")
        if osp.exists(frag_path):
            with open(frag_path, "rb") as f:
                self.metas: List[Dict] = pickle.load(f)
            if mode.endswith("_debug"):
                self.metas = self.metas[:8]
        else:
            self.metas = []

    def __len__(self):
        return len(self.metas)

    def _scene_dir(self, scene):
        sub = "scans_test" if self.mode.startswith("test") else "scans"
        return osp.join(self.datapath, sub, scene)

    def read_frame(self, scene: str, frame_id: int):
        d = self._scene_dir(scene)
        img = imread(osp.join(d, "color", f"{frame_id}.jpg"))
        depth = imread(osp.join(d, "depth", f"{frame_id}.png")).astype(np.float32) / 1000.0
        pose = read_matrix(osp.join(d, "pose", f"{frame_id}.txt"))
        intr = read_matrix(osp.join(d, "intrinsic", "intrinsic_depth.txt"))[:3, :3]
        return img, depth, intr, pose

    def __getitem__(self, idx: int) -> Dict:
        meta = self.metas[idx]
        imgs, depths, intrs, poses = [], [], [], []
        for fid in meta["image_ids"][: self.nviews]:
            img, depth, intr, pose = self.read_frame(meta["scene"], fid)
            imgs.append(img)
            depths.append(depth)
            intrs.append(intr.copy())
            poses.append(pose)
        data = dict(
            imgs=imgs, depth=depths, intrinsics=intrs, extrinsics=poses,
            vol_origin=np.asarray(meta.get("vol_origin", np.zeros(3)), np.float32),
            scene=meta["scene"], fragment=f"{meta['scene']}_{meta.get('fragment_id', idx)}",
            epoch=[self.epoch],
            scene_reset=np.float32(meta.get("scene_reset", idx == 0)),
        )
        if self.pipeline:
            data = self.pipeline(data)
        return data

    def evaluate(self, outputs, metric: str = "depth_mesh", save_path: Optional[str] = None,
                 n_proc: int = 2, max_depth: float = 10.0, **kwargs):
        """Mean over scenes of each scene's metrics; ``outputs`` holds
        ``scene_name`` and ``mesh_path`` lists (``tools/test.py``)."""
        scene_names = outputs.get("scene_name", [])
        jobs = [(scene, outputs["mesh_path"][i], self._scene_dir(scene), max_depth)
                for i, scene in enumerate(scene_names)]
        if not jobs:
            return {}
        if len(jobs) == 1 or n_proc <= 1:   # a worker's start would cost more than it saves
            per_scene = [eval_one_scene(job) for job in jobs]
        else:
            with get_context("spawn").Pool(min(n_proc, len(jobs))) as pool:
                per_scene = pool.map(eval_one_scene, jobs)

        agg: Dict[str, List[float]] = {}
        for m in per_scene:
            for k, v in m.items():
                agg.setdefault(k, []).append(v)
        return {k: float(np.mean(vals)) for k, vals in agg.items()}
