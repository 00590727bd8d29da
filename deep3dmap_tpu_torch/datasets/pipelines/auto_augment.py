"""Auto-augment policy transforms (the port's copy of
``deep3dmap_tpu/datasets/pipelines/auto_augment.py``): ``AutoAugment`` with
the geometric Shear, Rotate and Translate and the photometric Color,
Equalize, Brightness and Contrast transforms (the AutoAugment-for-detection
recipe, arXiv:1906.11172).

Fields: ``img`` plus optional ``gt_bboxes`` (N, 4 xyxy), ``gt_labels`` and
``gt_semantic_seg``.  The geometric transforms move boxes and segs with the
image; boxes shrunk below ``min_bbox_size`` are dropped with their labels.
Host numpy, with ``utils/image_ops.py``'s ``warp_affine`` and
``get_rotation_matrix_2d`` for OpenCV's; the draws come from the global
``np.random``, in JAX's order.
"""
from __future__ import annotations

import copy
from typing import Sequence

import numpy as np

from ...utils import image_ops
from ..builder import PIPELINES
from .compose import Compose

_MAX_LEVEL = 10


def level_to_value(level, max_value):
    return (level / _MAX_LEVEL) * max_value


def enhance_level_to_value(level, a=1.8, b=0.1):
    return (level / _MAX_LEVEL) * a + b


def random_negative(value, random_negative_prob):
    return -value if np.random.rand() < random_negative_prob else value


def _fill3(img_fill_val):
    if isinstance(img_fill_val, (int, float)):
        return tuple([float(img_fill_val)] * 3)
    val = tuple(float(v) for v in img_fill_val)
    assert len(val) == 3
    return val


class _GeometricBase:
    """Shared affine machinery: warp img/seg, transform + clip boxes."""

    min_bbox_size = 0.0

    def _warp(self, results, M, fill, seg_fill):
        img = np.asarray(results["img"])
        h, w = img.shape[:2]
        results["img"] = image_ops.warp_affine(img, M, (w, h), border_value=fill)
        if "gt_semantic_seg" in results:
            results["gt_semantic_seg"] = image_ops.warp_affine(
                np.asarray(results["gt_semantic_seg"]), M, (w, h), nearest=True,
                border_value=seg_fill)
        if "gt_bboxes" in results and len(results["gt_bboxes"]):
            bb = np.asarray(results["gt_bboxes"], np.float64)
            corners = np.stack([
                bb[:, [0, 1]], bb[:, [2, 1]], bb[:, [0, 3]], bb[:, [2, 3]],
            ], axis=1)                                   # (N, 4, 2)
            ones = np.ones((*corners.shape[:2], 1))
            tc = np.concatenate([corners, ones], -1) @ M.T  # (N, 4, 2)
            new = np.concatenate([tc.min(1), tc.max(1)], -1)
            new[:, 0::2] = np.clip(new[:, 0::2], 0, w)
            new[:, 1::2] = np.clip(new[:, 1::2], 0, h)
            keep = ((new[:, 2] - new[:, 0] > self.min_bbox_size)
                    & (new[:, 3] - new[:, 1] > self.min_bbox_size))
            results["gt_bboxes"] = new[keep].astype(np.float32)
            if "gt_labels" in results:
                results["gt_labels"] = np.asarray(results["gt_labels"])[keep]
        return results


@PIPELINES.register_module()
class Shear(_GeometricBase):
    """Shear image + boxes + seg."""

    def __init__(self, level, img_fill_val=128, seg_ignore_label=255,
                 prob=0.5, direction="horizontal", max_shear_magnitude=0.3,
                 random_negative_prob=0.5, interpolation="bilinear"):
        assert 0 <= level <= _MAX_LEVEL
        assert direction in ("horizontal", "vertical")
        assert 0 <= prob <= 1.0
        self.magnitude = level_to_value(level, max_shear_magnitude)
        self.fill = _fill3(img_fill_val)
        self.seg_fill = seg_ignore_label
        self.prob = prob
        self.direction = direction
        self.random_negative_prob = random_negative_prob

    def __call__(self, results):
        if np.random.rand() > self.prob:
            return results
        m = random_negative(self.magnitude, self.random_negative_prob)
        if self.direction == "horizontal":
            M = np.array([[1, m, 0], [0, 1, 0]], np.float64)
        else:
            M = np.array([[1, 0, 0], [m, 1, 0]], np.float64)
        return self._warp(results, M, self.fill, self.seg_fill)


@PIPELINES.register_module()
class Rotate(_GeometricBase):
    """Rotate about a center."""

    def __init__(self, level, scale=1, center=None, img_fill_val=128,
                 seg_ignore_label=255, prob=0.5, max_rotate_angle=30,
                 random_negative_prob=0.5):
        assert 0 <= level <= _MAX_LEVEL
        self.angle = level_to_value(level, max_rotate_angle)
        self.scale = scale
        self.center = center
        self.fill = _fill3(img_fill_val)
        self.seg_fill = seg_ignore_label
        self.prob = prob
        self.random_negative_prob = random_negative_prob

    def __call__(self, results):
        if np.random.rand() > self.prob:
            return results
        h, w = np.asarray(results["img"]).shape[:2]
        center = self.center or ((w - 1) * 0.5, (h - 1) * 0.5)
        angle = random_negative(self.angle, self.random_negative_prob)
        M = image_ops.get_rotation_matrix_2d(center, -angle, self.scale)
        return self._warp(results, M, self.fill, self.seg_fill)


@PIPELINES.register_module()
class Translate(_GeometricBase):
    """Translate along one axis."""

    min_bbox_size = 0.0

    def __init__(self, level, prob=0.5, img_fill_val=128,
                 seg_ignore_label=255, direction="horizontal",
                 max_translate_offset=250.0, random_negative_prob=0.5,
                 min_size=0):
        assert 0 <= level <= _MAX_LEVEL
        assert direction in ("horizontal", "vertical")
        self.offset = int(level_to_value(level, max_translate_offset))
        self.fill = _fill3(img_fill_val)
        self.seg_fill = seg_ignore_label
        self.prob = prob
        self.direction = direction
        self.random_negative_prob = random_negative_prob
        self.min_bbox_size = min_size

    def __call__(self, results):
        if np.random.rand() > self.prob:
            return results
        off = random_negative(self.offset, self.random_negative_prob)
        if self.direction == "horizontal":
            M = np.array([[1, 0, off], [0, 1, 0]], np.float64)
        else:
            M = np.array([[1, 0, 0], [0, 1, off]], np.float64)
        return self._warp(results, M, self.fill, self.seg_fill)


@PIPELINES.register_module()
class ColorTransform:
    """Saturation adjust."""

    def __init__(self, level, prob=0.5):
        assert 0 <= level <= _MAX_LEVEL
        self.factor = enhance_level_to_value(level)
        self.prob = prob

    def __call__(self, results):
        if np.random.rand() > self.prob:
            return results
        img = np.asarray(results["img"], np.float32)
        gray = img.mean(-1, keepdims=True)
        out = gray + (img - gray) * self.factor
        results["img"] = np.clip(out, 0, 255).astype(
            np.asarray(results["img"]).dtype)
        return results


@PIPELINES.register_module()
class EqualizeTransform:
    """Per-channel histogram equalization."""

    def __init__(self, prob=0.5):
        self.prob = prob

    @staticmethod
    def _equalize_channel(c):
        hist = np.bincount(c.ravel(), minlength=256)
        nonzero = hist[hist > 0]
        if len(nonzero) <= 1:
            return c
        step = (hist.sum() - nonzero[-1]) // 255
        if step == 0:
            return c
        lut = (np.cumsum(hist) - hist // 2) // step
        lut = np.clip(np.concatenate([[0], lut[:-1]]), 0, 255)
        return lut[c].astype(np.uint8)

    def __call__(self, results):
        if np.random.rand() > self.prob:
            return results
        img = np.asarray(results["img"])
        u8 = np.clip(img, 0, 255).astype(np.uint8)
        out = np.stack([self._equalize_channel(u8[..., i])
                        for i in range(u8.shape[-1])], -1)
        results["img"] = out.astype(img.dtype)
        return results


@PIPELINES.register_module()
class BrightnessTransform:
    """Blend with black."""

    def __init__(self, level, prob=0.5):
        assert 0 <= level <= _MAX_LEVEL
        self.factor = enhance_level_to_value(level)
        self.prob = prob

    def __call__(self, results):
        if np.random.rand() > self.prob:
            return results
        img = np.asarray(results["img"], np.float32)
        results["img"] = np.clip(img * self.factor, 0, 255).astype(
            np.asarray(results["img"]).dtype)
        return results


@PIPELINES.register_module()
class ContrastTransform:
    """Blend with the mean-gray image."""

    def __init__(self, level, prob=0.5):
        assert 0 <= level <= _MAX_LEVEL
        self.factor = enhance_level_to_value(level)
        self.prob = prob

    def __call__(self, results):
        if np.random.rand() > self.prob:
            return results
        img = np.asarray(results["img"], np.float32)
        mean = img.mean()
        results["img"] = np.clip(mean + (img - mean) * self.factor,
                                 0, 255).astype(np.asarray(results["img"]).dtype)
        return results


@PIPELINES.register_module()
class AutoAugment:
    """Pick one random policy (a Compose of transforms) per call
   ."""

    def __init__(self, policies: Sequence[Sequence[dict]]):
        assert policies and all(
            isinstance(p, (list, tuple)) and p for p in policies)
        self.policies = copy.deepcopy(policies)
        self.transforms = [Compose(list(p)) for p in self.policies]

    def __call__(self, results):
        return np.random.choice(self.transforms)(results)

    def __repr__(self):
        return f"{self.__class__.__name__}(policies={self.policies})"
