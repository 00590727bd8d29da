"""Gan2Shape's CelebA reader (port of
``deep3dmap_tpu/datasets/real_files.py::CelebaDataset``, :36-52 and
:165-237): an image list, an image root and one inverted StyleGAN latent
per image, ``.npy``/``.npz`` or a torch ``.pt``.

Host-side and independent of OpenCV: frames are read by ``utils/image_io.py``
(PNG by the port's codec; JPEG through ``cv2`` or ``PIL`` where one is
importable) and resized with ``cv2``'s ``INTER_AREA`` weights, its
``INTER_LINEAR`` ones for the depth maps (``image_io.resize_float``), as the
JAX reader's ``cv2.resize`` calls do.
"""
from __future__ import annotations

import os.path as osp
from typing import Dict, List, Optional

import numpy as np

from ..utils.image_io import imread, resize_float
from .builder import DATASETS


def imread_rgb(path: str) -> np.ndarray:
    """An image file -> float32 RGB (H, W, 3) in [0, 1]; grey is repeated
    and RGBA composited on white, as the JAX reader does."""
    img = imread(path)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    if img.shape[-1] == 4:
        a = img[..., 3:4].astype(np.float32) / 255.0
        img = img[..., :3].astype(np.float32) * a + 255.0 * (1 - a)
    img = img[..., :3][..., ::-1]   # BGR -> RGB
    return np.ascontiguousarray(img, np.float32) / 255.0


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
