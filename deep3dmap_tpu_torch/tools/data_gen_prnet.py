#!/usr/bin/env python
"""300W-LP -> PRNet training data: cropped face images and UV position maps
(the port's twin of ``tools/data_gen/prnet.py``).  Usage:

    python -m deep3dmap_tpu_torch.tools.data_gen_prnet -i Data/300W_LP -o Data/300W_LP_256 \\
        [--resolution 256] [--bfm magicbox/face/BFM.mat] [--bfm-info magicbox/face/BFM_info.mat] \\
        [--synthetic-bfm]

For each ``<name>.jpg`` of the input directory and its ``<name>.mat``
(``Pose_Para``, ``Shape_Para``, ``Exp_Para``), it synthesises the BFM mesh,
projects it with the 3DDFA weak-perspective camera, crops around the
projected landmarks with a seeded, perturbed similarity transform
(``utils/image_ops.warp_affine``, OpenCV's ``warpAffine`` without ``cv2``)
and rasterises the UV position map (each texel's image-space 3D position)
through the host C++ z-buffer ``ops/native.py::rasterize_mesh``.  It writes
``<name>_inp.jpg`` and ``<name>.npy``, the layout ``ThreeHundredWLPDataset``
reads, ``uv_kpt_ind.txt`` (the landmark texels PRNet's NME needs) and
``list.txt``.

The crops are written as PNG bytes under the ``_inp.jpg`` names, on every
machine (the port's readers take the format from the file's first bytes;
the JAX tool writes JPEG through ``cv2``, which the card's machine lacks).
The inputs may be PNG or JPEG; JPEG needs ``cv2`` or ``PIL``.
``--synthetic-bfm`` runs without the licensed BFM, on the seeded synthetic
one.  Host numpy throughout: no card.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import time
from glob import glob

import numpy as np

from ..ops import native
from ..utils import image_ops
from ..utils.image_io import imread, imwrite_png


def load_bfm_full(model_path: str, info_path: str):
    """The magicbox ``BFM.mat`` and ``BFM_info.mat`` pair -> (mu (3N,),
    w_shape (3N, S), w_exp (3N, E), tri (T, 3), kpt_ind (68,), uv_coords
    (N, 2) in [0, 1])."""
    import scipy.io as sio

    m = sio.loadmat(model_path)
    info = sio.loadmat(info_path)
    model = m["model"][0, 0] if "model" in m else m
    mu = np.asarray(model["shapeMU"], np.float64).reshape(-1)
    w_shape = np.asarray(model["shapePC"], np.float64)
    w_exp = np.asarray(model["expPC"], np.float64)
    tri = np.asarray(model["tri"], np.int64).T - 1
    kpt = np.asarray(model["kpt_ind"], np.int64).reshape(-1) - 1
    uv = np.asarray(info["uv_coords"], np.float64)
    if uv.shape[0] == 2:
        uv = uv.T
    return mu, w_shape, w_exp, tri, kpt, uv


def synthetic_bfm_full(n_verts: int = 512):
    """The seeded synthetic BFM in ``load_bfm_full``'s layout."""
    from ..core.all3dmm.bfm_tools import make_synthetic_bfm
    from ..models.frameworks.prnet import bfm_uv_coords

    bfm = make_synthetic_bfm(n_verts=n_verts)
    mu = bfm.mu_shape.numpy().reshape(-1)
    uv01 = bfm_uv_coords(bfm, 1000) / 999.0  # continuous [0, 1] uv coords
    return (mu, bfm.w_shape.numpy(), bfm.w_exp.numpy(), bfm.triangles.numpy(),
            bfm.keypoints.numpy(), uv01)


def angles_to_rotation(angles) -> np.ndarray:
    """3DDFA convention: R = Rx(phi) @ Ry(gamma) @ Rz(theta)."""
    phi, gamma, theta = float(angles[0]), float(angles[1]), float(angles[2])
    rx = np.array([[1, 0, 0], [0, np.cos(phi), -np.sin(phi)], [0, np.sin(phi), np.cos(phi)]])
    ry = np.array([[np.cos(gamma), 0, np.sin(gamma)], [0, 1, 0],
                   [-np.sin(gamma), 0, np.cos(gamma)]])
    rz = np.array([[np.cos(theta), -np.sin(theta), 0], [np.sin(theta), np.cos(theta), 0],
                   [0, 0, 1]])
    return rx @ ry @ rz


def project_3ddfa(vertices: np.ndarray, pose_para: np.ndarray) -> np.ndarray:
    """Weak-perspective projection of (3, N) vertices, 300W-LP's
    ``Pose_Para`` layout [phi, gamma, theta, tx, ty, tz, scale]."""
    s = float(pose_para[-1])
    R = angles_to_rotation(pose_para[:3])
    t = np.asarray(pose_para[3:6], np.float64).reshape(3, 1)
    return s * (R @ vertices) + t


def detect_kpt_box(kpt2d: np.ndarray, rs: np.random.RandomState):
    """The crop box around the projected landmarks, its centre and size
    perturbed by ``rs``."""
    left, right = kpt2d[0].min(), kpt2d[0].max()
    top, bottom = kpt2d[1].min(), kpt2d[1].max()
    center = np.array([right - (right - left) / 2.0, bottom - (bottom - top) / 2.0])
    old_size = (right - left + bottom - top) / 2
    size = int(old_size * 1.5)
    marg = old_size * 0.1
    center += rs.rand(2) * marg * 2 - marg
    size = size * (rs.rand() * 0.2 + 0.9)
    return center, float(size)


class GeneratePos:
    def __init__(self, resolution_inp: int = 256, resolution: int = 256,
                 model_path: str = "magicbox/face/BFM.mat",
                 info_path: str = "magicbox/face/BFM_info.mat",
                 synthetic: bool = False, seed: int = 0):
        self.resolution_inp = resolution_inp
        self.resolution = resolution
        self.rs = np.random.RandomState(seed)
        (self.mu, self.w_shape, self.w_exp, self.tri, self.kpt_ind, uv) = (
            synthetic_bfm_full() if synthetic else load_bfm_full(model_path, info_path))
        # the rasterisation geometry in UV space
        pv = np.zeros((3, len(self.mu) // 3))
        pv[:2] = (uv * (self.resolution - 1)).T
        pv[1] = self.resolution - 1 - pv[1]
        self.uv_vertices = pv

    def write_uv_kpt_ind(self, save_folder: str):
        ind = np.rint(self.uv_vertices[:2, self.kpt_ind]).astype(np.int64)
        np.savetxt(osp.join(save_folder, "uv_kpt_ind.txt"), ind, fmt="%d")

    def generate_vertices(self, shape_para, exp_para) -> np.ndarray:
        """(3, N): mu + W_shape alpha + W_exp beta (raw 300W-LP parameters)."""
        s = np.asarray(shape_para, np.float64).reshape(-1)[:self.w_shape.shape[1]]
        e = np.asarray(exp_para, np.float64).reshape(-1)[:self.w_exp.shape[1]]
        v = self.mu + self.w_shape[:, :len(s)] @ s + self.w_exp[:, :len(e)] @ e
        return v.reshape(-1, 3).T

    def process_arrays(self, image: np.ndarray, pose_para, shape_para, exp_para):
        """An RGB float32 image in [0, 1] and its parameters -> (the crop in
        [0, 1], the UV position map (R, R, 3))."""
        h = image.shape[0]
        vertices = self.generate_vertices(shape_para, exp_para)
        projected = project_3ddfa(vertices, np.asarray(pose_para).reshape(-1))
        projected[1] = h - 1 - projected[1]
        center, size = detect_kpt_box(projected[:, self.kpt_ind], self.rs)

        # the similarity crop: its three point pairs are axis-aligned, so
        # the map is a scale and a translation
        a = (self.resolution_inp - 1) / size
        tx = -a * (center[0] - size / 2)
        ty = -a * (center[1] - size / 2)
        M = np.array([[a, 0, tx], [0, a, ty]], np.float64)
        cropped = image_ops.warp_affine(np.asarray(image, np.float32), M,
                                        (self.resolution_inp, self.resolution_inp))
        verts = projected.copy()
        verts[0] = a * verts[0] + tx
        verts[1] = a * verts[1] + ty
        verts[2] = projected[2] * a
        verts[2] -= verts[2].min()
        # the UV position map: rasterise in UV space with the image-space
        # positions as the per-vertex attribute
        uv_pos, _ = native.rasterize_mesh(
            self.uv_vertices.T.astype(np.float32), self.tri.astype(np.int64),
            verts.T.astype(np.float32), self.resolution, self.resolution)
        return cropped, np.asarray(uv_pos, np.float32)

    def process(self, image_path: str, save_folder: str):
        import scipy.io as sio

        image = imread(image_path)[:, :, 2::-1].astype(np.float32) / np.float32(255.0)
        info = sio.loadmat(image_path.replace("jpg", "mat"))
        cropped, uv_pos = self.process_arrays(
            image, info["Pose_Para"].T.astype(np.float32).reshape(-1),
            info["Shape_Para"], info["Exp_Para"])
        out = osp.join(save_folder, osp.basename(image_path))
        crop = np.clip(np.rint(cropped * 255), 0, 255).astype(np.uint8)
        imwrite_png(out.replace(".jpg", "_inp.jpg"), crop[:, :, ::-1])
        np.save(out.replace(".jpg", ".npy"), uv_pos)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-i", "--inputDir", default="Data/300W_LP")
    ap.add_argument("-o", "--outputDir", default="Data/300W_LP_256")
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--bfm", default="magicbox/face/BFM.mat")
    ap.add_argument("--bfm-info", default="magicbox/face/BFM_info.mat")
    ap.add_argument("--synthetic-bfm", action="store_true",
                    help="use the seeded synthetic BFM (smoke runs)")
    args = ap.parse_args(argv)

    os.makedirs(args.outputDir, exist_ok=True)
    gp = GeneratePos(args.resolution, args.resolution, args.bfm, args.bfm_info,
                     synthetic=args.synthetic_bfm)
    gp.write_uv_kpt_ind(args.outputDir)
    paths = sorted(glob(osp.join(args.inputDir, "*.jpg")))
    st = time.time()
    names = []
    for i, p in enumerate(paths):
        if i % 1000 == 0:
            print(f"processed {i}/{len(paths)}; time: {(time.time() - st) / 60:.1f}min")
        gp.process(p, args.outputDir)
        names.append(osp.basename(p))
    with open(osp.join(args.outputDir, "list.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return names


if __name__ == "__main__":
    main()
