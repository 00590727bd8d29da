"""Formatting transforms (the port's copy of
``deep3dmap_tpu/datasets/pipelines/formating.py``): batches stay numpy
dicts, float32 leaves; placement on the card happens at upload
(``datasets/builder.py::prefetch_to_device``), not here.
"""
from __future__ import annotations

import numpy as np

from ..builder import PIPELINES


@PIPELINES.register_module()
class ToFloat32:
    def __init__(self, keys):
        self.keys = keys

    def __call__(self, data):
        for k in self.keys:
            v = data[k]
            if isinstance(v, (list, tuple)):
                data[k] = [np.asarray(x, np.float32) for x in v]
            else:
                data[k] = np.asarray(v, np.float32)
        return data


@PIPELINES.register_module()
class ImageToArray:
    """HWC uint8 image(s) -> float32 arrays (optionally scaled to [0,1])."""

    def __init__(self, keys=("img",), scale: bool = True):
        self.keys = keys
        self.scale = scale

    def __call__(self, data):
        for k in self.keys:
            v = np.asarray(data[k], np.float32)
            if self.scale:
                v = v / 255.0
            data[k] = v
        return data


@PIPELINES.register_module()
class ToTensor:
    """Array-ify to float32 numpy leaves (device placement happens at
    upload, not here)."""

    def __init__(self, keys):
        self.keys = keys

    def __call__(self, data):
        for k in self.keys:
            data[k] = np.asarray(data[k], np.float32)
        return data


@PIPELINES.register_module()
class GetKeysFromDict:
    """Hoist entries of a loaded dict (e.g. a .mat) into the results."""

    def __init__(self, in_dict_key="mat", out_keys=("pts3d",)):
        self.in_dict_key = in_dict_key
        self.out_keys = out_keys

    def __call__(self, data):
        src = data[self.in_dict_key]
        for k in self.out_keys:
            if k in src:
                data[k] = src[k]
        return data


@PIPELINES.register_module()
class FaceFormatBundle:
    """Format face-pipeline fields: image-like keys become
    contiguous float32 HWC arrays (NHWC here — no CHW transpose, no
    DataContainer), common keys become float32 arrays, and default meta keys
    (<key>_pad_shape/<key>_scale_factor) are added."""

    def __init__(self, imglike_keys=("img", "uvimg"),
                 common_keys=("tform_mat",)):
        self.imglike_keys = imglike_keys
        self.common_keys = common_keys

    def __call__(self, data):
        for k in self.imglike_keys:
            if k not in data:
                continue
            img = np.asarray(data[k], np.float32)
            if img.ndim < 3:
                img = img[..., None]
            data.setdefault(f"{k}_pad_shape", img.shape)
            data.setdefault(f"{k}_scale_factor", 1.0)
            data[k] = np.ascontiguousarray(img)
        for k in self.common_keys:
            if k in data:
                data[k] = np.asarray(data[k], np.float32)
        return data


@PIPELINES.register_module()
class Collect:
    """Keep only ``keys``; metadata keys are passed through unstacked."""

    def __init__(self, keys, meta_keys=()):
        self.keys = keys
        self.meta_keys = meta_keys

    def __call__(self, data):
        out = {k: data[k] for k in self.keys}
        for k in self.meta_keys:
            if k in data:
                out[k] = data[k]
        return out
