"""VOC-style mean Average Precision over box detections (the port's copy of
``deep3dmap_tpu/core/evaluation/mean_ap.py``).

``average_precision`` ('area' and '11points'), greedy TP/FP matching
(``tpfp_default``), per-class gathering and ``eval_map``: host numpy, as in
the JAX package.  Inputs may be tensors on any device (``as_host`` copies
them to numpy); the summaries go through the port's logger.
"""
from __future__ import annotations

import numpy as np

from ...utils.logging import print_log

__all__ = ["average_precision", "bbox_overlaps_np", "tpfp_default",
           "eval_map", "print_map_summary", "as_host"]


def as_host(x):
    """A tensor (any device) as a numpy array; lists, tuples and dicts
    converted leaf by leaf; anything else as it is."""
    if hasattr(x, "detach") and hasattr(x, "cpu"):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(as_host(v) for v in x)
    if isinstance(x, dict):
        return {k: as_host(v) for k, v in x.items()}
    return x


def bbox_overlaps_np(bboxes1: np.ndarray, bboxes2: np.ndarray,
                     eps: float = 1e-6) -> np.ndarray:
    """IoU matrix (n, m) between two (x1,y1,x2,y2) box arrays."""
    bboxes1, bboxes2 = as_host(bboxes1), as_host(bboxes2)
    bboxes1 = np.asarray(bboxes1, np.float64).reshape(-1, 4)
    bboxes2 = np.asarray(bboxes2, np.float64).reshape(-1, 4)
    n, m = len(bboxes1), len(bboxes2)
    if n == 0 or m == 0:
        return np.zeros((n, m))
    lt = np.maximum(bboxes1[:, None, :2], bboxes2[None, :, :2])
    rb = np.minimum(bboxes1[:, None, 2:], bboxes2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area1 = np.prod(bboxes1[:, 2:] - bboxes1[:, :2], axis=1)
    area2 = np.prod(bboxes2[:, 2:] - bboxes2[:, :2], axis=1)
    union = area1[:, None] + area2[None, :] - inter
    return inter / np.maximum(union, eps)


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      mode: str = "area") -> np.ndarray:
    """AP from (num_scales, num_dets) recall/precision curves.

    mode 'area': area under the monotonized PR curve; '11points': mean of
    max precision at recall in {0, 0.1, ..., 1.0}."""
    recalls, precisions = np.asarray(as_host(recalls)), np.asarray(as_host(precisions))
    no_scale = recalls.ndim == 1
    recalls = np.atleast_2d(recalls)
    precisions = np.atleast_2d(precisions)
    num_scales = recalls.shape[0]
    ap = np.zeros(num_scales)
    if mode == "area":
        zeros = np.zeros((num_scales, 1))
        ones = np.ones((num_scales, 1))
        mrec = np.hstack((zeros, recalls, ones))
        mpre = np.hstack((zeros, precisions, zeros))
        mpre = np.maximum.accumulate(mpre[:, ::-1], axis=1)[:, ::-1]
        for i in range(num_scales):
            ind = np.where(mrec[i, 1:] != mrec[i, :-1])[0]
            ap[i] = np.sum((mrec[i, ind + 1] - mrec[i, ind]) * mpre[i, ind + 1])
    elif mode == "11points":
        for i in range(num_scales):
            for thr in np.arange(0, 1 + 1e-3, 0.1):
                precs = precisions[i, recalls[i, :] >= thr]
                ap[i] += precs.max() if precs.size > 0 else 0.0
        ap /= 11
    else:
        raise ValueError('mode must be "area" or "11points"')
    return ap[0] if no_scale else ap


def tpfp_default(det_bboxes: np.ndarray, gt_bboxes: np.ndarray,
                 gt_bboxes_ignore: np.ndarray | None = None,
                 iou_thr: float = 0.5):
    """Greedy highest-score-first matching of detections to GT.

    det_bboxes (k, 5) with score column; returns (tp, fp) each (k,)."""
    det_bboxes, gt_bboxes = as_host(det_bboxes), as_host(gt_bboxes)
    gt_bboxes_ignore = as_host(gt_bboxes_ignore)
    det_bboxes = np.asarray(det_bboxes, np.float64).reshape(-1, 5)
    gt_bboxes = np.asarray(gt_bboxes, np.float64).reshape(-1, 4)
    if gt_bboxes_ignore is None:
        gt_bboxes_ignore = np.zeros((0, 4))
    gt_bboxes_ignore = np.asarray(gt_bboxes_ignore, np.float64).reshape(-1, 4)

    num_dets, num_gts = len(det_bboxes), len(gt_bboxes)
    tp = np.zeros(num_dets)
    fp = np.zeros(num_dets)
    if num_dets == 0:
        return tp, fp
    if num_gts == 0:
        # everything not covered by an ignore region is a false positive
        if len(gt_bboxes_ignore):
            ious_ign = bbox_overlaps_np(det_bboxes[:, :4], gt_bboxes_ignore)
            fp = (ious_ign.max(axis=1) < iou_thr).astype(np.float64)
        else:
            fp[:] = 1
        return tp, fp

    ious = bbox_overlaps_np(det_bboxes[:, :4], gt_bboxes)
    ious_max = ious.max(axis=1)
    ious_argmax = ious.argmax(axis=1)
    sort_inds = np.argsort(-det_bboxes[:, 4])
    gt_covered = np.zeros(num_gts, bool)
    for i in sort_inds:
        if ious_max[i] >= iou_thr:
            matched = ious_argmax[i]
            if not gt_covered[matched]:
                gt_covered[matched] = True
                tp[i] = 1
            else:
                fp[i] = 1
        else:
            if len(gt_bboxes_ignore):
                ious_ign = bbox_overlaps_np(det_bboxes[i:i + 1, :4],
                                            gt_bboxes_ignore)
                if ious_ign.size and ious_ign.max() >= iou_thr:
                    continue  # inside an ignore region: neither tp nor fp
            fp[i] = 1
    return tp, fp


def _get_cls_results(det_results, annotations, class_id):
    cls_dets = [det[class_id] for det in det_results]
    cls_gts, cls_gts_ignore = [], []
    for ann in annotations:
        gt_inds = np.asarray(ann["labels"]) == class_id
        cls_gts.append(np.asarray(ann["bboxes"]).reshape(-1, 4)[gt_inds])
        if ann.get("labels_ignore", None) is not None:
            ign_inds = np.asarray(ann["labels_ignore"]) == class_id
            cls_gts_ignore.append(
                np.asarray(ann["bboxes_ignore"]).reshape(-1, 4)[ign_inds])
        else:
            cls_gts_ignore.append(np.zeros((0, 4)))
    return cls_dets, cls_gts, cls_gts_ignore


def eval_map(det_results, annotations, iou_thr: float = 0.5,
             mode: str = "area", logger=None):
    """mAP over classes.

    det_results: per-image list of per-class (k, 5) arrays.
    annotations: per-image dicts with 'bboxes' (n,4), 'labels' (n,), and
    optional 'bboxes_ignore'/'labels_ignore'.
    Returns (mean_ap, per-class result dicts)."""
    det_results, annotations = as_host(det_results), as_host(annotations)
    assert len(det_results) == len(annotations)
    num_classes = len(det_results[0])
    eval_results = []
    for c in range(num_classes):
        cls_dets, cls_gts, cls_gts_ignore = _get_cls_results(
            det_results, annotations, c)
        tp_list, fp_list = [], []
        for dets, gts, gts_ign in zip(cls_dets, cls_gts, cls_gts_ignore):
            tp, fp = tpfp_default(dets, gts, gts_ign, iou_thr)
            tp_list.append(tp)
            fp_list.append(fp)
        num_gts = sum(len(g) for g in cls_gts)
        all_dets = np.vstack([np.asarray(d, np.float64).reshape(-1, 5)
                              for d in cls_dets])
        num_dets = len(all_dets)
        sort_inds = np.argsort(-all_dets[:, 4])
        tp = np.concatenate(tp_list)[sort_inds] if num_dets else np.zeros(0)
        fp = np.concatenate(fp_list)[sort_inds] if num_dets else np.zeros(0)
        tp_cum = np.cumsum(tp)
        fp_cum = np.cumsum(fp)
        eps = np.finfo(np.float32).eps
        recalls = tp_cum / max(num_gts, eps)
        precisions = tp_cum / np.maximum(tp_cum + fp_cum, eps)
        ap = average_precision(recalls, precisions, mode) if num_dets else 0.0
        eval_results.append({
            "num_gts": num_gts,
            "num_dets": num_dets,
            "recall": float(recalls[-1]) if num_dets and num_gts else 0.0,
            "precision": float(precisions[-1]) if num_dets else 0.0,
            "ap": float(ap),
        })
    aps = [r["ap"] for r in eval_results if r["num_gts"] > 0]
    mean_ap = float(np.mean(aps)) if aps else 0.0
    if logger is not None:
        print_map_summary(mean_ap, eval_results, logger=logger)
    return mean_ap, eval_results


def print_map_summary(mean_ap, results, class_names=None, logger=None):
    """Tabular per-class AP summary, through ``print_log`` (printed when
    ``logger`` is None)."""
    def emit(line):
        print_log(line, logger)
    header = f"{'class':>12} {'gts':>8} {'dets':>8} {'recall':>8} {'ap':>8}"
    emit(header)
    for i, r in enumerate(results):
        name = class_names[i] if class_names else str(i)
        emit(f"{name:>12} {r['num_gts']:>8d} {r['num_dets']:>8d} "
             f"{r['recall']:>8.3f} {r['ap']:>8.3f}")
    emit(f"{'mAP':>12} {'':>8} {'':>8} {'':>8} {mean_ap:>8.3f}")
