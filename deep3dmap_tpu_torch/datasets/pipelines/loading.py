"""Loading transforms (the port's copy of
``deep3dmap_tpu/datasets/pipelines/loading.py``).

``LoadImageFromFile`` reads as ``cv2.imread(path, cv2.IMREAD_COLOR)`` does,
through ``utils/image_io.py``'s own PNG decoder (BGR, or RGB with
``color_order="rgb"``); ``LoadArrayUsingNp`` and ``LoadMatDictUsingSio``
use numpy and scipy.
"""
from __future__ import annotations

import os.path as osp

import numpy as np

from ...utils.image_io import imread_color
from ..builder import PIPELINES


@PIPELINES.register_module()
class LoadImageFromFile:
    def __init__(self, key: str = "img", path_key: str = "img_path",
                 to_float32: bool = False, color_order: str = "bgr"):
        self.key = key
        self.path_key = path_key
        self.to_float32 = to_float32
        self.color_order = color_order

    def __call__(self, data):
        path = data[self.path_key]
        if not osp.isfile(path):
            raise FileNotFoundError(path)
        img = imread_color(path)
        if self.color_order == "rgb":
            img = img[..., ::-1]
        if self.to_float32:
            img = img.astype(np.float32)
        data[self.key] = img
        data[f"{self.key}_shape"] = img.shape
        return data


@PIPELINES.register_module()
class LoadArrayUsingNp:
    def __init__(self, key: str = "arr", path_key: str = "arr_path",
                 allow_pickle: bool = False):
        self.key = key
        self.path_key = path_key
        self.allow_pickle = allow_pickle

    def __call__(self, data):
        data[self.key] = np.load(data[self.path_key], allow_pickle=self.allow_pickle)
        return data


@PIPELINES.register_module()
class LoadMatDictUsingSio:
    def __init__(self, key: str = "mat", path_key: str = "mat_path",
                 fields=None):
        self.key = key
        self.path_key = path_key
        self.fields = fields

    def __call__(self, data):
        import scipy.io as sio

        mat = sio.loadmat(data[self.path_key])
        if self.fields:
            mat = {f: mat[f] for f in self.fields}
        data[self.key] = mat
        return data
