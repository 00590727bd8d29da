"""Multi-view face tuples for imgs2mesh (port of
``deep3dmap_tpu/datasets/face_tuple.py``).

``SyntheticFaceTupleDataset``: V views of a random identity of the
synthetic BFM, the ground-truth points, and per-view aux vectors in the
reference's 152-float ``gtaux`` layout (lm68[136], s, R[9], t[3],
angles[3]), with images made from the latent parameters by a fixed random
decoder.  ``MultiPIEFaceTupleDataset``: the layout
``tools/data_gen/multipie.py organize`` writes -- two pickled indexes, the
images, and registered ``.obj`` scans.

Host readers: ``device`` is the keyword the CLIs pass every dataset, and
the items are numpy arrays.  Images are read by ``utils/image_io.py`` as
``cv2.imread(path)`` reads them (3-channel BGR) and resized with
``cv2.resize``'s ``INTER_LINEAR`` (``image_ops.resize``, without ``cv2``).
The pickled indexes hold plain dicts and numpy arrays and are read with the
standard library's ``pickle``: load only indexes this program's data-gen
wrote.
"""
from __future__ import annotations

import os.path as osp
import pickle
from typing import Dict

import numpy as np
import torch

from ..core.all3dmm.bfm_tools import BFMModel, make_synthetic_bfm, param2points_bfm
from ..core.all3dtrans.lmk2angle import matrix2angle
from ..core.all3dtrans.rotations import euler_angles_to_matrix
from ..utils.image_io import imread
from ..utils.image_ops import resize
from .builder import DATASETS


@DATASETS.register_module()
class SyntheticFaceTupleDataset:
    state = "sup"

    def __init__(self, n_samples: int = 8, tuplesize: int = 3, image_size: int = 64,
                 bfm: BFMModel = None, n_verts: int = 512, seed: int = 0,
                 pipeline=None, device=None):
        self.n_samples = n_samples
        self.tuplesize = tuplesize
        self.image_size = image_size
        self.bfm = (bfm if bfm is not None else make_synthetic_bfm(n_verts=n_verts)).to("cpu")
        self.seed = seed
        rs = np.random.RandomState(seed + 999)
        n_param = self.bfm.n_shape + self.bfm.n_exp + 7
        self._dec = rs.randn(n_param, image_size * image_size * 3).astype(np.float32) * 0.05
        self._cache: Dict[int, Dict] = {}

    def __len__(self):
        return self.n_samples

    def _make(self, idx: int) -> Dict:
        rs = np.random.RandomState(self.seed + idx)
        ns, ne = self.bfm.n_shape, self.bfm.n_exp
        V, S = self.tuplesize, self.image_size

        theta = rs.randn(ns + ne).astype(np.float32) * 0.1
        imgs, poses = [], []
        for _ in range(V):
            scale = np.float32(1e-3 + rs.rand() * 1e-3)
            angles = rs.uniform(-0.4, 0.4, 3).astype(np.float32)
            T = rs.uniform(0.2, 0.8, 3).astype(np.float32)
            pose = np.concatenate([[scale], angles, T]).astype(np.float32)
            poses.append(pose)
            img = np.tanh(np.concatenate([theta, pose]) @ self._dec).reshape(S, S, 3) * 0.5 + 0.5
            imgs.append(img.astype(np.float32))

        preds = torch.from_numpy(np.concatenate([theta, poses[0]])[None])
        gtobj = param2points_bfm(self.bfm, preds)[0][0].numpy()
        kp = self.bfm.keypoints.numpy()
        gtaux = []
        for pose in poses:
            R = euler_angles_to_matrix(torch.from_numpy(pose[1:4]), "XYZ").numpy()
            proj = pose[0] * (gtobj @ R.T) + pose[4:7][None] * S
            gtaux.append(np.concatenate([
                proj[kp, :2].astype(np.float32).reshape(-1), [pose[0]], R.reshape(-1),
                pose[4:7], pose[1:4]]).astype(np.float32))
        return dict(imgs=np.stack(imgs), gtobj=gtobj.astype(np.float32),
                    gtaux=np.stack(gtaux))

    def __getitem__(self, idx):
        if idx not in self._cache:
            self._cache[idx] = self._make(idx)
        return self._cache[idx]


@DATASETS.register_module()
class MultiPIEFaceTupleDataset:
    """MultiPIE multi-view tuples from the data-gen's pickled indexes (JAX
    :91-190): each sample is ``tuplesize`` views of one capture, drawn by
    ``RandomState(seed + idx)``, with the registered scan as ``gtobj`` and
    the per-view aux in the 152-float ``gtaux`` layout.

    Args:
        datadir: directory with the two pickled indexes.
        imgdir: the image root the indexes' paths are relative to.
        objroot: directory with the registered scans ``<id>_<sess>_<rec>.obj``.
        tuplesize: views per sample.
        image_size: the output image side (resized square).
    """

    state = "sup"

    def __init__(self, datadir: str, imgdir: str, objroot: str,
                 tuplesize: int = 3, image_size: int = 64, seed: int = 0,
                 uvtex_index: str = "multipie_uvtex2poseimgs.pkl",
                 aux_index: str = "multipie_imgpath2auxinfo.pkl",
                 pipeline=None, device=None):
        self.imgdir = imgdir
        self.objroot = objroot
        self.tuplesize = tuplesize
        self.image_size = image_size
        self.seed = seed
        with open(osp.join(datadir, uvtex_index), "rb") as f:
            uvtex2poseimgs = pickle.load(f)
        with open(osp.join(datadir, aux_index), "rb") as f:
            self.aux = pickle.load(f)
        # one entry per capture with at least tuplesize usable views
        self.entries = []
        for uvtex, pose2imgs in sorted(uvtex2poseimgs.items()):
            paths = [p for ps in pose2imgs.values() for p in ps if self._usable(p)]
            if len(paths) >= tuplesize:
                self.entries.append((uvtex, sorted(paths)))

    def _usable(self, path):
        a = self.aux.get(path)
        return a is not None and not np.isscalar(a.get("lm68"))

    def __len__(self):
        return len(self.entries)

    def _load_image(self, path):
        """float32 RGB (S, S, 3) in [0, 1] and the file's (w, h)."""
        img = imread(osp.join(self.imgdir, path))
        if img.ndim == 2:
            img = img[..., None].repeat(3, axis=-1)
        h, w = img.shape[:2]
        rgb = np.ascontiguousarray(img[:, :, 2::-1])
        img = resize(rgb, (self.image_size, self.image_size))
        return img.astype(np.float32) / 255.0, (w, h)

    def __getitem__(self, idx):
        uvtex, paths = self.entries[idx]
        pick = np.random.RandomState(self.seed + idx).choice(len(paths), self.tuplesize,
                                                             replace=False)
        S = self.image_size
        imgs, gtaux = [], []
        for i in pick:
            path = paths[int(i)]
            img, (w, h) = self._load_image(path)
            imgs.append(img)
            a = self.aux[path]
            # landmarks, scale and translation into the resized image's pixels
            sx, sy = S / float(w), S / float(h)
            lm68 = np.asarray(a["lm68"], np.float32) * np.asarray([[sx, sy]], np.float32)
            s = np.float32(a["s"]) * np.float32(sx)
            R = np.asarray(a["R"], np.float64)
            t = np.asarray(a["t"], np.float64).reshape(-1)[:3] * np.asarray([sx, sy, 1.0])
            ang = np.asarray(matrix2angle(R), np.float32)
            gtaux.append(np.concatenate([
                lm68.reshape(-1), [s], R.reshape(-1).astype(np.float32),
                t.astype(np.float32), ang]).astype(np.float32))
        key = osp.basename(uvtex).split(".")[0]
        gtobj = _read_obj_verts(osp.join(self.objroot, key + ".obj")).astype(np.float32)
        return dict(imgs=np.stack(imgs), gtobj=gtobj, gtaux=np.stack(gtaux))


def _read_obj_verts(objpath: str) -> np.ndarray:
    """Vertex positions (N, 3) float64 from a ``.obj``'s ``v`` lines."""
    verts = []
    with open(objpath) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
    return np.asarray(verts, np.float64)
