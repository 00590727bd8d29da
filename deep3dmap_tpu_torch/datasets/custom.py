"""``CustomDataset``: the annotation-file detection dataset with mAP and
recall evaluation (the port's copy of ``deep3dmap_tpu/datasets/custom.py``).

Annotation format (pickle/json through ``utils/fileio.load``)::

    [{ 'filename': 'a.jpg', 'width': 1280, 'height': 720,
       'ann': { 'bboxes': (n, 4) float32, 'labels': (n,) int64,
                'bboxes_ignore': (k, 4), 'labels_ignore': (k,) } }, ...]

A host reader, as in the JAX package: ``prepare_*`` give numpy dicts for the
loader to stack, the aspect ``flag`` feeds ``GroupSampler``, and
``evaluate`` runs ``core/evaluation``'s ``eval_map`` and ``eval_recalls``
on the host (detections may be tensors).  ``device`` is the keyword the
CLIs pass every dataset; nothing here uses it.
"""
from __future__ import annotations

import os.path as osp
from typing import List, Optional

import numpy as np

from ..core.evaluation.mean_ap import eval_map
from ..core.evaluation.recall import eval_recalls
from ..utils import fileio
from .builder import DATASETS
from .pipelines.compose import Compose


@DATASETS.register_module()
class CustomDataset:

    CLASSES: Optional[tuple] = None

    def __init__(self, ann_file, pipeline, classes=None, data_root=None,
                 img_prefix="", seg_prefix=None, proposal_file=None,
                 test_mode: bool = False, filter_empty_gt: bool = True, device=None):
        self.ann_file = ann_file
        self.data_root = data_root
        self.img_prefix = img_prefix
        self.seg_prefix = seg_prefix
        self.proposal_file = proposal_file
        self.test_mode = test_mode
        self.filter_empty_gt = filter_empty_gt
        self.CLASSES = self.get_classes(classes)

        if self.data_root is not None:
            if not osp.isabs(self.ann_file):
                self.ann_file = osp.join(self.data_root, self.ann_file)
            if not (self.img_prefix is None or osp.isabs(self.img_prefix)):
                self.img_prefix = osp.join(self.data_root, self.img_prefix)
            if not (self.proposal_file is None
                    or osp.isabs(self.proposal_file)):
                self.proposal_file = osp.join(self.data_root,
                                              self.proposal_file)

        self.data_infos = self.load_annotations(self.ann_file)
        self.proposals = (self.load_proposals(self.proposal_file)
                          if self.proposal_file is not None else None)

        if not test_mode:
            valid_inds = self._filter_imgs()
            self.data_infos = [self.data_infos[i] for i in valid_inds]
            if self.proposals is not None:
                self.proposals = [self.proposals[i] for i in valid_inds]
            self._set_group_flag()

        self.pipeline = Compose(pipeline) if pipeline is not None else None

    def __len__(self):
        return len(self.data_infos)

    def load_annotations(self, ann_file):
        return fileio.load(ann_file)

    def load_proposals(self, proposal_file):
        return fileio.load(proposal_file)

    def get_ann_info(self, idx):
        return self.data_infos[idx]["ann"]

    def get_cat_ids(self, idx):
        return np.asarray(
            self.data_infos[idx]["ann"]["labels"]).astype(int).tolist()

    def pre_pipeline(self, results):
        results["img_prefix"] = self.img_prefix
        results["seg_prefix"] = self.seg_prefix
        results["proposal_file"] = self.proposal_file
        results["bbox_fields"] = []
        results["mask_fields"] = []
        results["seg_fields"] = []
        return results

    def _filter_imgs(self, min_size: int = 32) -> List[int]:
        valid_inds = []
        for i, info in enumerate(self.data_infos):
            if self.filter_empty_gt and len(info["ann"]["labels"]) == 0:
                continue
            if min(info["width"], info["height"]) >= min_size:
                valid_inds.append(i)
        return valid_inds

    def _set_group_flag(self):
        """Aspect-ratio grouping flag for GroupSampler."""
        self.flag = np.zeros(len(self), np.uint8)
        for i, info in enumerate(self.data_infos):
            if info["width"] / info["height"] > 1:
                self.flag[i] = 1

    def _rand_another(self, idx):
        pool = np.where(self.flag == self.flag[idx])[0]
        return int(np.random.choice(pool))

    def __getitem__(self, idx):
        if self.test_mode:
            return self.prepare_test_img(idx)
        while True:
            data = self.prepare_train_img(idx)
            if data is None:
                idx = self._rand_another(idx)
                continue
            return data

    def prepare_train_img(self, idx):
        info = self.data_infos[idx]
        results = dict(img_info=info, ann_info=self.get_ann_info(idx))
        if self.proposals is not None:
            results["proposals"] = self.proposals[idx]
        self.pre_pipeline(results)
        return self.pipeline(results) if self.pipeline else results

    def prepare_test_img(self, idx):
        info = self.data_infos[idx]
        results = dict(img_info=info)
        if self.proposals is not None:
            results["proposals"] = self.proposals[idx]
        self.pre_pipeline(results)
        return self.pipeline(results) if self.pipeline else results

    @classmethod
    def get_classes(cls, classes=None):
        if classes is None:
            return cls.CLASSES
        if isinstance(classes, str):
            with open(classes) as f:
                return tuple(line.strip() for line in f if line.strip())
        if isinstance(classes, (tuple, list)):
            return tuple(classes)
        raise ValueError(f"Unsupported type {type(classes)} of classes.")

    def format_results(self, results, **kwargs):
        raise NotImplementedError

    def evaluate(self, results, metric="mAP", logger=None,
                 proposal_nums=(100, 300, 1000), iou_thr=0.5,
                 scale_ranges=None):
        """results: list (len == len(self)) of per-class det lists."""
        if not isinstance(metric, str):
            assert len(metric) == 1
            metric = metric[0]
        allowed_metrics = ["mAP", "recall"]
        if metric not in allowed_metrics:
            raise KeyError(f"metric {metric} is not supported")
        annotations = [self.get_ann_info(i) for i in range(len(self))]
        eval_results = {}
        if metric == "mAP":
            iou_thrs = [iou_thr] if isinstance(iou_thr, float) else iou_thr
            mean_aps = []
            for thr in iou_thrs:
                mean_ap, _ = eval_map(results, annotations, iou_thr=thr,
                                      logger=logger)
                mean_aps.append(mean_ap)
                eval_results[f"AP{int(thr * 100):02d}"] = round(mean_ap, 3)
            eval_results["mAP"] = sum(mean_aps) / len(mean_aps)
        else:
            gt_bboxes = [np.asarray(ann["bboxes"]) for ann in annotations]
            recalls = eval_recalls(gt_bboxes, results, proposal_nums, iou_thr)
            for i, num in enumerate(proposal_nums):
                for j, thr in enumerate(np.atleast_1d(iou_thr)):
                    eval_results[f"recall@{num}@{thr}"] = recalls[i, j]
            if recalls.shape[1] > 1:
                ar = recalls.mean(axis=1)
                for i, num in enumerate(proposal_nums):
                    eval_results[f"AR@{num}"] = ar[i]
        return eval_results

    def __repr__(self):
        return (f"{type(self).__name__}(num_samples={len(self)}, "
                f"classes={self.CLASSES})")
