"""Test-time augmentation (the port's copy of
``deep3dmap_tpu/datasets/pipelines/test_time_aug.py``): ``MultiScaleFlipAug``
fans a sample out over scales and flip directions, runs the inner pipeline
on each copy and returns per-key lists; ``InstaBoost`` needs the
``instaboostfast`` package and raises JAX's ``ImportError`` without it.
"""
from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np

from ..builder import PIPELINES
from .compose import Compose


@PIPELINES.register_module()
class MultiScaleFlipAug:
    """results -> dict of per-key LISTS, one entry per (scale, flip) combo.

    Each augmented copy carries ``scale``/``scale_factor`` and ``flip`` +
    ``flip_direction`` keys for the inner pipeline's Resize/RandomFlip to
    consume; the inner pipeline runs once per combo.
    """

    def __init__(self, transforms: Sequence[dict], img_scale=None,
                 scale_factor=None, flip: bool = False,
                 flip_direction="horizontal"):
        self.transforms = Compose(list(transforms))
        assert (img_scale is None) ^ (scale_factor is None), \
            "exactly one of img_scale / scale_factor must be set"
        if img_scale is not None:
            self.img_scale = (img_scale if isinstance(img_scale, list)
                              else [img_scale])
            assert all(isinstance(s, tuple) for s in self.img_scale)
            self.scale_key = "scale"
        else:
            self.img_scale = (scale_factor if isinstance(scale_factor, list)
                              else [scale_factor])
            self.scale_key = "scale_factor"
        self.flip = flip
        self.flip_direction = (flip_direction if isinstance(flip_direction, list)
                               else [flip_direction])
        assert all(isinstance(d, str) for d in self.flip_direction)
        if not self.flip and self.flip_direction != ["horizontal"]:
            warnings.warn("flip_direction has no effect when flip=False")

    def __call__(self, results):
        aug_data = []
        flip_args = [(False, None)]
        if self.flip:
            flip_args += [(True, d) for d in self.flip_direction]
        for scale in self.img_scale:
            for do_flip, direction in flip_args:
                r = dict(results)
                r[self.scale_key] = scale
                r["flip"] = do_flip
                r["flip_direction"] = direction
                aug_data.append(self.transforms(r))
        # list-of-dicts -> dict-of-lists
        out = {k: [d[k] for d in aug_data] for k in aug_data[0]}
        return out

    def __repr__(self):
        return (f"{self.__class__.__name__}(transforms={self.transforms}, "
                f"{self.scale_key}={self.img_scale}, flip={self.flip}, "
                f"flip_direction={self.flip_direction})")


@PIPELINES.register_module()
class InstaBoost:
    """InstaBoost copy-paste augmentation (arXiv:1908.07801) through the
    ``instaboostfast`` package; raises an actionable ImportError when it is
    absent.  Expects COCO-style ``ann_info`` with labels/bboxes/masks and
    the loaded ``img``.
    """

    def __init__(self, action_candidate=("normal", "horizontal", "skip"),
                 action_prob=(1, 0, 0), scale=(0.8, 1.2), dx=15, dy=15,
                 theta=(-1, 1), color_prob=0.5, hflag=False,
                 aug_ratio=0.5):
        try:
            import instaboostfast as instaboost
        except ImportError:
            raise ImportError(
                'Please run "pip install instaboostfast" to install '
                "instaboostfast first for instaboost augmentation.")
        self.cfg = instaboost.InstaBoostConfig(
            action_candidate, action_prob, scale, dx, dy, theta,
            color_prob, hflag)
        self.aug_ratio = aug_ratio

    def _load_anns(self, results):
        labels = results["ann_info"]["labels"]
        masks = results["ann_info"]["masks"]
        bboxes = results["ann_info"]["bboxes"]
        anns = []
        for label, bbox, mask in zip(labels, bboxes, masks):
            x1, y1, x2, y2 = bbox
            anns.append(dict(category_id=int(label), segmentation=mask,
                             bbox=[x1, y1, x2 - x1, y2 - y1]))
        return anns

    def _parse_anns(self, results, anns, img):
        labels, bboxes, masks = [], [], []
        for ann in anns:
            x1, y1, w, h = ann["bbox"]
            if w <= 0 or h <= 0:
                continue
            labels.append(ann["category_id"])
            bboxes.append([x1, y1, x1 + w, y1 + h])
            masks.append(ann["segmentation"])
        results["ann_info"]["labels"] = np.array(labels, dtype=np.int64)
        results["ann_info"]["bboxes"] = np.array(bboxes, dtype=np.float32)
        results["ann_info"]["masks"] = masks
        results["img"] = img
        return results

    def __call__(self, results):
        import instaboostfast as instaboost

        img = np.asarray(results["img"]).astype(np.uint8)
        anns = self._load_anns(results)
        if np.random.rand() < self.aug_ratio:
            anns, img = instaboost.get_new_data(anns, img, self.cfg,
                                                background=None)
        return self._parse_anns(results, anns, img)
