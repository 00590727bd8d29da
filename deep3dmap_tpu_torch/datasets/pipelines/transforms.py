"""2D image transforms (the port's copy of
``deep3dmap_tpu/datasets/pipelines/transforms.py``): Resize, Normalize,
flips, pads, crops, the GAN and face helpers and PhotoMetricDistortion.

Host numpy, as in the JAX package, with ``utils/image_ops.py`` in place of
OpenCV (``cv2.resize``, ``cv2.warpAffine``, ``cv2.getAffineTransform`` and
the HSV conversions, bit for bit).  Each transform that draws keeps JAX's
``np.random.RandomState(seed)`` draws in JAX's order, so one seed gives
JAX's augmentation.
"""
from __future__ import annotations

import numpy as np

from ...utils import image_ops
from ..builder import PIPELINES


def _resize(img, size):
    return image_ops.resize(img, size)


@PIPELINES.register_module()
class Resize:
    def __init__(self, size, keys=("img",)):
        self.size = tuple(size)  # (w, h)
        self.keys = keys

    def __call__(self, data):
        for k in self.keys:
            data[k] = _resize(np.asarray(data[k]), self.size)
        return data


@PIPELINES.register_module()
class Normalize:
    def __init__(self, mean, std, keys=("img",), to_rgb: bool = False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.keys = keys
        self.to_rgb = to_rgb

    def __call__(self, data):
        for k in self.keys:
            img = np.asarray(data[k], np.float32)
            if self.to_rgb:
                img = img[..., ::-1]
            data[k] = (img - self.mean) / self.std
        return data


@PIPELINES.register_module()
class RandomFlip:
    def __init__(self, prob: float = 0.5, keys=("img",), seed: int = 0):
        self.prob = prob
        self.keys = keys
        self.rs = np.random.RandomState(seed)

    def __call__(self, data):
        if self.rs.rand() < self.prob:
            for k in self.keys:
                data[k] = np.ascontiguousarray(np.asarray(data[k])[:, ::-1])
            data["flipped"] = True
        else:
            data["flipped"] = False
        return data


@PIPELINES.register_module()
class Pad:
    def __init__(self, size_divisor: int = 32, keys=("img",), value: float = 0.0):
        self.size_divisor = size_divisor
        self.keys = keys
        self.value = value

    def __call__(self, data):
        d = self.size_divisor
        for k in self.keys:
            img = np.asarray(data[k])
            H, W = img.shape[:2]
            ph = (d - H % d) % d
            pw = (d - W % d) % d
            pad = [(0, ph), (0, pw)] + [(0, 0)] * (img.ndim - 2)
            data[k] = np.pad(img, pad, constant_values=self.value)
        return data


@PIPELINES.register_module()
class CenterCrop:
    def __init__(self, size, keys=("img",)):
        self.size = size  # (h, w)
        self.keys = keys

    def __call__(self, data):
        th, tw = self.size
        for k in self.keys:
            img = np.asarray(data[k])
            H, W = img.shape[:2]
            y0 = max((H - th) // 2, 0)
            x0 = max((W - tw) // 2, 0)
            data[k] = img[y0:y0 + th, x0:x0 + tw]
        return data


@PIPELINES.register_module()
class RandomCrop:
    """Random spatial crop."""

    def __init__(self, size, keys=("img",), seed: int = 0):
        self.size = size  # (h, w)
        self.keys = keys
        self.rs = np.random.RandomState(seed)

    def __call__(self, data):
        th, tw = self.size
        ref = np.asarray(data[self.keys[0]])
        H, W = ref.shape[:2]
        y0 = self.rs.randint(0, max(H - th, 0) + 1)
        x0 = self.rs.randint(0, max(W - tw, 0) + 1)
        for k in self.keys:
            data[k] = np.asarray(data[k])[y0:y0 + th, x0:x0 + tw]
        data["crop_offset"] = (y0, x0)
        return data


@PIPELINES.register_module()
class NormalizeForGAN:
    """[0,1] image -> [-1,1] (Gan2Shape/GNeRF configs).  Operates on dict
    keys, or on a bare array (a torchvision-style call)."""

    def __init__(self, keys=("img",)):
        self.keys = keys

    def __call__(self, data):
        if not isinstance(data, dict):
            return np.asarray(data, np.float32) * 2.0 - 1.0
        for k in self.keys:
            if k in data:
                data[k] = np.asarray(data[k], np.float32) * 2.0 - 1.0
        return data


@PIPELINES.register_module()
class BlendAToRGB:
    """RGBA -> RGB composited on white (Blender renders).  NHWC: alpha is
    the last channel."""

    def __init__(self, keys=("img",)):
        self.keys = keys

    def __call__(self, data):
        def blend(x):
            x = np.asarray(x, np.float32)
            if x.shape[-1] == 4:
                rgb, a = x[..., :3], x[..., 3:]
                x = rgb * a + (1.0 - a)
            return x

        if not isinstance(data, dict):
            return blend(data)
        for k in self.keys:
            if k in data:
                data[k] = blend(data[k])
        return data


@PIPELINES.register_module()
class FaceLandmarkCrop:
    """Similarity-crop a face from landmarks or a bbox to a square input:
    estimate the 3-point similarity transform from the
    landmark bounding square to the output square, warp, and keep the
    transform for mapping predictions back."""

    def __init__(self, in_lm_key="pt3d_68", in_img_key="img",
                 out_lm_key="lm68", out_img_key="faceimg",
                 out_trans_key="tform_mat", resolution_inp: int = 256,
                 scale: float = 1.5):
        self.in_lm_key = in_lm_key
        self.in_img_key = in_img_key
        self.out_lm_key = out_lm_key
        self.out_img_key = out_img_key
        self.out_trans_key = out_trans_key
        self.resolution_inp = resolution_inp
        self.scale = scale

    def __call__(self, data):
        kpt = np.asarray(data[self.in_lm_key], np.float64)
        is_lm = max(kpt.shape) > 4
        if is_lm:  # landmarks
            if kpt.shape[0] > 3:
                kpt = kpt.T  # -> (2or3, N)
            left, right = kpt[0].min(), kpt[0].max()
            top, bottom = kpt[1].min(), kpt[1].max()
        else:  # bbox [l, r, t, b]
            left, right, top, bottom = kpt.reshape(-1)[:4]
        old_size = (right - left + bottom - top) / 2.0
        center = np.array([right - (right - left) / 2.0,
                           bottom - (bottom - top) / 2.0])
        size = int(old_size * self.scale)

        res = self.resolution_inp
        src = np.float32([[center[0] - size / 2, center[1] - size / 2],
                          [center[0] - size / 2, center[1] + size / 2],
                          [center[0] + size / 2, center[1] - size / 2]])
        dst = np.float32([[0, 0], [0, res - 1], [res - 1, 0]])
        M = image_ops.get_affine_transform(src, dst)  # 2x3 crop transform
        tform = np.vstack([M, [0.0, 0.0, 1.0]]).astype(np.float32)

        img = np.asarray(data[self.in_img_key], np.float32)
        cropped = image_ops.warp_affine(img, M, (res, res))
        data[self.out_img_key] = cropped
        data[self.out_trans_key] = tform
        if is_lm:
            data[self.out_lm_key] = np.asarray(kpt[:2, :], np.float32)
        return data


@PIPELINES.register_module()
class PhotoMetricDistortion:
    """Random brightness/contrast/saturation/hue jitter over [0,255] float
    NHWC images."""

    def __init__(self, brightness_delta: float = 32,
                 contrast_range=(0.5, 1.5), saturation_range=(0.5, 1.5),
                 hue_delta: float = 18, keys=("img",), seed: int = 0):
        self.brightness_delta = brightness_delta
        self.contrast_range = contrast_range
        self.saturation_range = saturation_range
        self.hue_delta = hue_delta
        self.keys = keys
        self.rs = np.random.RandomState(seed)

    def _jitter(self, img):
        rs = self.rs
        img = np.asarray(img, np.float32)
        if rs.randint(2):
            img = img + rs.uniform(-self.brightness_delta,
                                   self.brightness_delta)
        if rs.randint(2):
            img = img * rs.uniform(*self.contrast_range)
        hsv = image_ops.rgb_to_hsv(
            np.clip(img, 0, 255).astype(np.uint8)).astype(np.float32)
        if rs.randint(2):
            hsv[..., 1] *= rs.uniform(*self.saturation_range)
        if rs.randint(2):
            hsv[..., 0] = (hsv[..., 0] +
                           rs.uniform(-self.hue_delta, self.hue_delta)) % 180
        hsv[..., 1:] = np.clip(hsv[..., 1:], 0, 255)
        return image_ops.hsv_to_rgb(hsv.astype(np.uint8)).astype(np.float32)

    def __call__(self, data):
        for k in self.keys:
            data[k] = self._jitter(data[k])
        return data
