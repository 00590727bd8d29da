"""Proposal recall (the port's copy of
``deep3dmap_tpu/core/evaluation/recall.py``): ``eval_recalls`` over a grid
of proposal counts and IoU thresholds by greedy best-IoU matching, host
numpy; tensors are accepted and copied to the host.
"""
from __future__ import annotations

import numpy as np

from ...utils.logging import print_log
from .mean_ap import as_host, bbox_overlaps_np

__all__ = ["set_recall_param", "eval_recalls", "print_recall_summary"]


def set_recall_param(proposal_nums, iou_thrs):
    """Normalize inputs to 1-d arrays."""
    if isinstance(proposal_nums, (list, tuple)):
        proposal_nums = np.array(proposal_nums)
    elif isinstance(proposal_nums, int):
        proposal_nums = np.array([proposal_nums])
    if iou_thrs is None:
        iou_thrs = np.array([0.5])
    elif isinstance(iou_thrs, (list, tuple)):
        iou_thrs = np.array(iou_thrs)
    elif isinstance(iou_thrs, float):
        iou_thrs = np.array([iou_thrs])
    return proposal_nums, iou_thrs


def _recalls(all_ious, proposal_nums, thrs):
    """all_ious: per-image (num_gts, num_proposals) IoU matrices with
    proposals already sorted by score. Greedy per-GT best match."""
    img_num = len(all_ious)
    total_gt_num = sum(ious.shape[0] for ious in all_ious)
    _ious = np.zeros((proposal_nums.size, total_gt_num), np.float32)
    for k, proposal_num in enumerate(proposal_nums):
        tmp_ious = np.zeros(0, np.float32)
        for i in range(img_num):
            ious = all_ious[i][:, :proposal_num].copy()
            gt_ious = np.zeros(ious.shape[0], np.float32)
            if ious.size == 0:
                tmp_ious = np.hstack((tmp_ious, gt_ious))
                continue
            for j in range(ious.shape[0]):
                gt_max_overlaps = ious.argmax(axis=1)
                max_ious = ious[np.arange(ious.shape[0]), gt_max_overlaps]
                gt_idx = max_ious.argmax()
                gt_ious[j] = max_ious[gt_idx]
                box_idx = gt_max_overlaps[gt_idx]
                ious[gt_idx, :] = -1
                ious[:, box_idx] = -1
            tmp_ious = np.hstack((tmp_ious, gt_ious))
        _ious[k, :] = tmp_ious
    _ious = _ious[:, None, :] >= thrs[None, :, None]
    return _ious.mean(axis=2).astype(np.float32)  # (num_nums, num_thrs)


def eval_recalls(gts, proposals, proposal_nums=None, iou_thrs=0.5,
                 logger=None):
    """Recall grid over proposal counts and IoU thresholds.

    gts: per-image (n, 4) GT boxes; proposals: per-image (k, 4) or (k, 5)
    arrays (score column used to sort). Returns (len(proposal_nums),
    len(iou_thrs)) recall matrix."""
    gts, proposals = as_host(gts), as_host(proposals)
    assert len(gts) == len(proposals)
    proposal_nums, iou_thrs = set_recall_param(
        proposal_nums if proposal_nums is not None else 100, iou_thrs)
    all_ious = []
    for gt, prop in zip(gts, proposals):
        prop = np.asarray(prop, np.float64)
        if prop.ndim == 2 and prop.shape[1] == 5:
            prop = prop[np.argsort(-prop[:, 4])][:, :4]
        prop = prop.reshape(-1, 4)[:proposal_nums.max()]
        gt = np.asarray(gt, np.float64).reshape(-1, 4)
        if gt.shape[0] == 0:
            all_ious.append(np.zeros((0, prop.shape[0])))
        else:
            all_ious.append(bbox_overlaps_np(gt, prop))
    recalls = _recalls(all_ious, proposal_nums, iou_thrs)
    if logger is not None:
        print_recall_summary(recalls, proposal_nums, iou_thrs, logger=logger)
    return recalls


def print_recall_summary(recalls, proposal_nums, iou_thrs, logger=None):
    """Tabular recall summary, through ``print_log`` (printed when
    ``logger`` is None)."""
    def emit(line):
        print_log(line, logger)
    header = " ".join([f"{'num':>6}"] + [f"{t:>6.2f}" for t in iou_thrs])
    emit(header)
    for i, num in enumerate(proposal_nums):
        row = " ".join([f"{num:>6d}"] + [f"{r:>6.3f}" for r in recalls[i]])
        emit(row)
