"""Real-file readers (port of ``deep3dmap_tpu/datasets/real_files.py``):
GNeRF's NeRF-synthetic scenes (``BlenderDataset``, :55-102) and DTU scans
(``DTUDataset``, :105-162), Gan2Shape's CelebA (``CelebaDataset``, :36-52 and :165-237: an image list,
an image root and one inverted StyleGAN latent per image, ``.npy``/``.npz``
or a torch ``.pt``) and PRNet's 300W-LP (``ThreeHundredWLPDataset``,
:240-315: ``*_inp.jpg`` crops with ``.npy`` UV position maps, and NME
``evaluate``).

Host-side and independent of OpenCV: frames are read by ``utils/image_io.py``
(PNG by the port's codec; JPEG through ``cv2`` or ``PIL`` where one is
importable; the format comes from the file's first bytes, as in
``cv2.imread``, so PNG bytes under a ``.jpg`` name read without a decoder)
and resized with ``cv2``'s ``INTER_AREA`` weights, its ``INTER_LINEAR``
ones for the depth and UV maps (``image_io.resize_float``, the latter
through ``image_ops.resize``), as the JAX readers' ``cv2.resize`` calls do.
"""
from __future__ import annotations

import glob
import json
import os.path as osp
from typing import Dict, List, Optional

import numpy as np

from ..core.evaluation.face_eval import eval_nme
from ..utils.device import resolve_device
from ..utils.image_io import imread, resize_float, resize_uint8_area
from .builder import DATASETS


def imread_rgb(path: str) -> np.ndarray:
    """An image file -> float32 RGB (H, W, 3) in [0, 1]; grey is repeated
    and RGBA composited on white, as the JAX reader does."""
    return _rgb01(imread(path))


def _rgb01(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    if img.shape[-1] == 4:
        a = img[..., 3:4].astype(np.float32) / 255.0
        img = img[..., :3].astype(np.float32) * a + 255.0 * (1 - a)
    img = img[..., :3][..., ::-1]   # BGR -> RGB
    return np.ascontiguousarray(img, np.float32) / 255.0


def _read_resized(path: str, img_wh) -> np.ndarray:
    """``imread_rgb`` resized to ``img_wh`` (W, H) with ``INTER_AREA``, as
    the JAX reader's ``cv2.resize``: on float levels for RGBA (composited
    first), on the ``uint8`` levels, rounded, for grey and RGB."""
    raw = imread(path)
    if (raw.shape[1], raw.shape[0]) == tuple(img_wh):
        return _rgb01(raw)
    if raw.ndim == 3 and raw.shape[-1] == 4:
        return resize_float(_rgb01(raw), tuple(img_wh), area=True)
    rgb = raw[..., None].repeat(3, axis=-1) if raw.ndim == 2 else raw[..., :3][..., ::-1]
    return np.ascontiguousarray(resize_uint8_area(rgb, tuple(img_wh)), np.float32) / 255.0


@DATASETS.register_module(name=["BlenderDataset", "Blender"])
class BlenderDataset:
    """A NeRF-synthetic (Blender) scene: ``transforms_<split>.json`` and
    ``<split>/*.png`` (RGBA composited on white).  The ``val`` split keeps
    its first 8 images.  Intrinsics from ``camera_angle_x`` with the
    principal point at the image centre, scaled to ``img_wh``, whose aspect
    ratio must be the images'.  Items: ``imgs`` (H, W, 3) in [-1, 1] and
    ``img_idx``, host arrays.  ``device`` is resolved as every entry point's
    (CUDA unless ``"cpu"``; raises without a GPU), the GNeRF path's rule."""

    name = "blender"

    def __init__(self, data_dir: str, split: str = "train", img_wh=(400, 400),
                 white_background: bool = True, pipeline=None, sort_key=None, device=None):
        self.device = resolve_device(device)
        self.data_dir, self.split = data_dir, split
        self.img_wh = tuple(img_wh)
        self.pipeline = pipeline
        filenames = sorted(glob.glob(f"{data_dir}/{split}/*.png"), key=sort_key)
        if split == "val":
            filenames = filenames[:8]
        if not filenames:
            raise FileNotFoundError(f"no {split} images under {data_dir}")
        self.filenames = filenames
        with open(osp.join(data_dir, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        self.poses = np.stack([np.asarray(fr["transform_matrix"], np.float32)[:3, :4]
                               for fr in meta["frames"]])
        oh, ow = imread(filenames[0]).shape[:2]
        if oh * self.img_wh[0] != ow * self.img_wh[1]:
            raise ValueError(f"img_wh must keep the {ow}x{oh} aspect ratio")
        focal = 0.5 * ow / np.tan(0.5 * float(meta["camera_angle_x"]))
        K = np.array([[focal, 0, ow // 2], [0, focal, oh // 2], [0, 0, 1]], np.float32)
        K[:2] *= np.array([self.img_wh[0] / ow, self.img_wh[1] / oh], np.float32)[:, None]
        self.intrinsics = K
        self.images = [_read_resized(p, self.img_wh) * 2.0 - 1.0 for p in filenames]

    def __len__(self):
        return len(self.filenames)

    def __getitem__(self, idx: int) -> Dict:
        item = dict(imgs=self.images[idx], img_idx=np.int32(idx))
        return self.pipeline(item) if self.pipeline else item


@DATASETS.register_module(name=["DTUDataset", "DTU"])
class DTUDataset:
    """A DTU scan at one light (``*_3_*.png``); every 8th image (from the
    8th) is the ``val`` split, the rest ``train``.  Cameras from
    ``<data_dir>/../../Cameras/train/<view-1:08d>_cam.txt``: the pose is
    the inverse of ``extrinsic`` with its translation over ``trans_scale``;
    ``intrinsic`` is at a quarter of the image size (x4), averaged over the
    split and scaled to ``img_wh``.  Items as ``BlenderDataset``'s."""

    name = "dtu"

    def __init__(self, data_dir: str, split: str = "train", img_wh=(400, 300),
                 pipeline=None, sort_key=None, trans_scale: float = 200.0, device=None):
        self.device = resolve_device(device)
        self.data_dir, self.split = data_dir, split
        self.img_wh = tuple(img_wh)
        self.pipeline = pipeline
        filenames = sorted(glob.glob(f"{data_dir}/*_3_*.png"), key=sort_key)
        if not filenames:
            raise FileNotFoundError(f"no *_3_*.png images under {data_dir}")
        val_idx = set(range(7, len(filenames), 8))
        keep = (val_idx if split == "val"
                else [i for i in range(len(filenames)) if i not in val_idx])
        self.filenames = [filenames[i] for i in sorted(keep)]
        oh, ow = imread(self.filenames[0]).shape[:2]
        cam_dir = osp.join(osp.dirname(osp.dirname(data_dir.rstrip("/"))), "Cameras", "train")
        poses, intrinsics = [], []
        for name in self.filenames:
            view_id = int(osp.basename(name)[5:8]) - 1
            with open(osp.join(cam_dir, f"{view_id:08d}_cam.txt")) as f:
                text = f.read().splitlines()
            ei, ki = text.index("extrinsic"), text.index("intrinsic")
            E = np.array([[float(v) for v in row.split()] for row in text[ei + 1:ei + 5]],
                         np.float32)
            K = np.array([[float(v) for v in row.split()] for row in text[ki + 1:ki + 4]],
                         np.float32)
            K[:2] *= 4.0
            poses.append(np.linalg.inv(E)[:3, :4])
            intrinsics.append(K)
        self.poses = np.stack(poses)
        self.poses[:, :, 3] /= trans_scale
        K = np.mean(intrinsics, axis=0)
        K[:2] *= np.array([self.img_wh[0] / ow, self.img_wh[1] / oh], np.float32)[:, None]
        self.intrinsics = K.astype(np.float32)
        self.images = [_read_resized(p, self.img_wh) * 2.0 - 1.0 for p in self.filenames]

    def __len__(self):
        return len(self.filenames)

    def __getitem__(self, idx: int) -> Dict:
        item = dict(imgs=self.images[idx], img_idx=np.int32(idx))
        return self.pipeline(item) if self.pipeline else item


def load_latent(path: str) -> np.ndarray:
    """A latent file as float32: ``.npy``, the first array of an ``.npz``,
    or a ``.pt`` tensor (or the first value of a dict of them) read with
    ``torch.load(weights_only=True)``."""
    if path.endswith((".npy", ".npz")):
        arr = np.load(path, allow_pickle=False)
        if hasattr(arr, "files"):
            with arr:
                arr = arr[arr.files[0]]
        return np.asarray(arr, np.float32)
    import torch

    t = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(t, dict):
        t = next(iter(t.values()))
    return t.detach().cpu().numpy().astype(np.float32)


@DATASETS.register_module()
class CelebaDataset:
    """CelebA instances: images with their precomputed (inverted) latents.

    Each line of ``img_list_path`` names an image under ``img_root``; its
    latent is ``latent_root/<name>.pt`` or, without one, ``.npy``.  Items:
    ``input_im`` (S, S, 3) in [-1, 1] after the optional centre ``crop`` and
    a resize to ``image_size``; ``latent_w``; with ``load_gt_depth`` also
    ``depth_gt`` in [-1, 1] from the image path with "image" replaced by
    "depth".  ``device`` is the keyword the CLIs pass every dataset; the
    items are host arrays and the runner moves them."""

    def __init__(self, img_list_path: str, img_root: str, latent_root: str,
                 image_size: int = 128, crop: Optional[int] = None,
                 load_gt_depth: bool = False, pipeline=None, device=None):
        self.image_size = image_size
        self.crop = crop
        self.load_gt_depth = load_gt_depth
        self.img_list: List[str] = []
        self.latent_list: List[str] = []
        self.depth_list: List[str] = []
        with open(img_list_path) as f:
            for line in f:
                if not line.strip():
                    continue
                img_name = line.split()[0]
                self.img_list.append(osp.join(img_root, img_name))
                base = img_name.rsplit(".", 1)[0]
                lat = osp.join(latent_root, base + ".pt")
                if not osp.exists(lat):
                    lat = osp.join(latent_root, base + ".npy")
                self.latent_list.append(lat)
                if load_gt_depth:
                    self.depth_list.append(
                        osp.join(img_root, img_name).replace("image", "depth"))

    def __len__(self):
        return len(self.img_list)

    def _center_crop(self, img: np.ndarray) -> np.ndarray:
        if self.crop is None:
            return img
        h, w = img.shape[:2]
        top, left = (h - self.crop) // 2, (w - self.crop) // 2
        return img[top:top + self.crop, left:left + self.crop]

    def _resized(self, img: np.ndarray, area: bool) -> np.ndarray:
        if img.shape[0] == self.image_size:
            return img
        return resize_float(img, (self.image_size,) * 2, area=area)

    def __getitem__(self, idx: int) -> Dict:
        img = self._resized(self._center_crop(imread_rgb(self.img_list[idx])), area=True)
        item = dict(input_im=(img * 2.0 - 1.0).astype(np.float32),
                    latent_w=load_latent(self.latent_list[idx]))
        if self.load_gt_depth:
            d = self._center_crop(imread_rgb(self.depth_list[idx])[..., 0])
            d = self._resized(d, area=False)
            item["depth_gt"] = ((1.0 - d) * 2.0 - 1.0).astype(np.float32)
        return item

    def setup_input(self, idx: int) -> Dict:
        """One instance with a leading batch axis of 1 (the runner's pull)."""
        s = self[idx % len(self)]
        return {k: np.asarray(v)[None] for k, v in s.items()}


@DATASETS.register_module()
class ThreeHundredWLPDataset:
    """300W-LP PRNet training data: each line of ``datapath`` names
    ``<name>.jpg``; the item reads ``<name>_inp.jpg`` and ``<name>.npy``
    under ``img_prefix`` (lines without both files are skipped).  Items:
    ``faceimg`` (R, R, 3) in [0, 1], ``gt_uvimg`` the position map over
    R - 1 clipped to [0, 1], an identity ``tform_mat`` and zero
    ``gt_kpt_proj2d``.  ``evaluate`` needs the landmark texel indices
    (``uv_kpt_ind`` or ``uv_kpt_ind_file``) and raises without them.
    ``device`` is the keyword the CLIs pass every dataset."""

    CLASSES = ("face",)

    def __init__(self, datapath: str, img_prefix: str = "", pipeline=None,
                 resolution: int = 256, test_mode: bool = False,
                 uv_kpt_ind=None, uv_kpt_ind_file: Optional[str] = None, device=None):
        self.img_prefix = img_prefix
        self.resolution = resolution
        self.test_mode = test_mode
        self.pipeline = pipeline
        if uv_kpt_ind is not None:
            self.uv_kpt_ind = np.asarray(uv_kpt_ind, np.int64)
        elif uv_kpt_ind_file:
            self.uv_kpt_ind = np.loadtxt(uv_kpt_ind_file).astype(np.int64)
        else:
            self.uv_kpt_ind = None
        self.data_infos: List[Dict] = []
        with open(datapath) as f:
            for line in f:
                name = line.strip()
                if not name:
                    continue
                img_file = name.replace(".jpg", "_inp.jpg")
                uv_file = img_file.replace("_inp.jpg", ".npy")
                if (osp.exists(osp.join(img_prefix, img_file))
                        and osp.exists(osp.join(img_prefix, uv_file))):
                    self.data_infos.append(dict(filename=img_file, uv_file=uv_file))

    def __len__(self):
        return len(self.data_infos)

    def __getitem__(self, idx: int) -> Dict:
        info = self.data_infos[idx]
        img = imread_rgb(osp.join(self.img_prefix, info["filename"]))
        uv = np.load(osp.join(self.img_prefix, info["uv_file"])).astype(np.float32)
        S = self.resolution
        if img.shape[0] != S:
            img = resize_float(img, (S, S), area=True)
        if uv.shape[0] != S:
            uv = resize_float(uv, (S, S), area=False) * (S / uv.shape[0])
        uv01 = np.clip(uv / max(S - 1, 1), 0.0, 1.0).astype(np.float32)
        item = dict(faceimg=img.astype(np.float32), gt_uvimg=uv01,
                    tform_mat=np.eye(3, dtype=np.float32),
                    gt_kpt_proj2d=np.zeros((2, 68), np.float32))
        return self.pipeline(item) if self.pipeline else item

    def evaluate(self, results, metric: str = "nme", **kwargs):
        """NME against the landmarks read from the GT UV maps (the
        ``AFLW2000.py:131`` contract); ``results["kpt"]`` as ``tools/test.py``
        collects it."""
        if metric not in ("nme", "rmse"):
            raise KeyError(f"metric {metric} is not supported")
        if self.uv_kpt_ind is None:
            raise ValueError(
                "ThreeHundredWLPDataset.evaluate: NME requires the real landmark "
                "texel indices -- construct the dataset with "
                "uv_kpt_ind_file=<path to uv_kpt_ind.txt> (or uv_kpt_ind=)")
        kpt = np.concatenate(results["kpt"], axis=0)
        n = min(kpt.shape[0], len(self))
        ind = self.uv_kpt_ind
        items = [self[i] for i in range(n)]
        gt = np.stack([it["gt_uvimg"][ind[1], ind[0], :2].T * 255.0 for it in items])
        tforms = np.stack([it["tform_mat"] for it in items])
        return {"nme": eval_nme(kpt[:n], tforms, gt)}
