"""3D box ops: BEV and 3D rotated IoU, 3D NMS, RoI-aware and RoI-point
pooling (port of ``deep3dmap_tpu/ops/box3d.py``).

Boxes are (N, 7) ``[cx, cy, cz, dx, dy, dz, yaw]``.  The BEV IoU is the
port's rotated IoU (``ops/bbox.py::box_iou_rotated``, relative corners;
~1e-7 from JAX's on metre-scale boxes).  ``nms3d``/``nms3d_normal`` build
their IoU matrix on the device and scan it greedily on the host after one
copy, as JAX scans it in numpy: one host sync per call.

TRAP: ``roiaware_pool3d`` ignores ``max_pts_per_voxel``, as JAX's does: every
point of a voxel takes part in its max or mean.  Its sums add each voxel's
points in point order (``segment_reduce`` after a stable sort), a fixed
order on every device; the RoIs are pooled in chunks so that no buffer
grows past ``_POOL_ELEMS`` values.

Numpy inputs go to ``resolve_device(device)``: the card unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from .bbox import _host, _tensor, _upload, box_iou_rotated
from .voxel import count_ids

_POOL_ELEMS = 1 << 26


def _to_bev(boxes):
    """(N, 7) 3D boxes -> (N, 5) rotated BEV rects (cx, cy, dx, dy, yaw)."""
    return torch.stack([boxes[:, 0], boxes[:, 1], boxes[:, 3], boxes[:, 4], boxes[:, 6]], -1)


def boxes_iou_bev(boxes_a, boxes_b, device=None):
    """Rotated bird's-eye-view IoU matrix."""
    a = _tensor(boxes_a, device)
    b = _tensor(boxes_b, like=a)
    return box_iou_rotated(_to_bev(a), _to_bev(b))


def boxes_overlap_bev(boxes_a, boxes_b, device=None):
    """BEV intersection areas, ``iou * (A + B) / (1 + iou)``."""
    a = _tensor(boxes_a, device)
    b = _tensor(boxes_b, like=a)
    iou = box_iou_rotated(_to_bev(a), _to_bev(b))
    area_a = (a[:, 3] * a[:, 4])[:, None]
    area_b = (b[:, 3] * b[:, 4])[None, :]
    return iou * (area_a + area_b) / (1.0 + iou)


def boxes_iou3d(boxes_a, boxes_b, device=None):
    """3D IoU: BEV overlap times the z overlap, over the union volume."""
    a = _tensor(boxes_a, device)
    b = _tensor(boxes_b, like=a)
    inter_bev = boxes_overlap_bev(a, b)
    za1, za2 = a[:, 2] - a[:, 5] / 2, a[:, 2] + a[:, 5] / 2
    zb1, zb2 = b[:, 2] - b[:, 5] / 2, b[:, 2] + b[:, 5] / 2
    zo = torch.clamp(torch.minimum(za2[:, None], zb2[None, :])
                     - torch.maximum(za1[:, None], zb1[None, :]), min=0.0)
    inter = inter_bev * zo
    vol_a = (a[:, 3] * a[:, 4] * a[:, 5])[:, None]
    vol_b = (b[:, 3] * b[:, 4] * b[:, 5])[None, :]
    return inter / torch.clamp(vol_a + vol_b - inter, min=1e-8)


def _greedy_nms(ious: np.ndarray, scores: np.ndarray, thr: float) -> np.ndarray:
    order = np.argsort(-scores, kind="stable")
    alive = np.ones(len(scores), bool)
    keep = []
    for i in order:
        if not alive[i]:
            continue
        keep.append(int(i))
        alive &= ious[i] <= thr
    return np.array(keep, np.int64)


def _nms_host(ious: torch.Tensor, scores: torch.Tensor, thr: float) -> torch.Tensor:
    host = _host(torch.cat([ious, scores[None]]))          # the call's one copy
    keep = _greedy_nms(host[:-1], host[-1], thr)
    return _upload(keep, ious.device)


def nms3d(boxes, scores, iou_threshold: float, device=None):
    """Greedy NMS on the rotated BEV IoU -> kept indices (int64, on the
    boxes' device) in descending score order."""
    boxes = _tensor(boxes, device)
    return _nms_host(boxes_iou_bev(boxes, boxes), _tensor(scores, like=boxes), iou_threshold)


def nms3d_normal(boxes, scores, iou_threshold: float, device=None):
    """Greedy NMS on the axis-aligned BEV IoU (the yaw is ignored)."""
    b = _tensor(boxes, device)
    x1, y1 = b[:, 0] - b[:, 3] / 2, b[:, 1] - b[:, 4] / 2
    x2, y2 = b[:, 0] + b[:, 3] / 2, b[:, 1] + b[:, 4] / 2
    xx1 = torch.maximum(x1[:, None], x1[None, :])
    yy1 = torch.maximum(y1[:, None], y1[None, :])
    xx2 = torch.minimum(x2[:, None], x2[None, :])
    yy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = torch.clamp(xx2 - xx1, min=0) * torch.clamp(yy2 - yy1, min=0)
    area = (x2 - x1) * (y2 - y1)
    ious = inter / torch.clamp(area[:, None] + area[None, :] - inter, min=1e-8)
    return _nms_host(ious, _tensor(scores, like=b), iou_threshold)


def _canonical(points, boxes):
    """points (..., N, 3) into the frames of boxes (..., T, 7) ->
    (..., T, N, 3)."""
    shifted = points[..., None, :, :] - boxes[..., :, None, :3]
    yaw = -boxes[..., :, None, 6]
    c, s = torch.cos(yaw), torch.sin(yaw)
    x = shifted[..., 0] * c - shifted[..., 1] * s
    y = shifted[..., 0] * s + shifted[..., 1] * c
    return torch.stack([x, y, shifted[..., 2]], -1)


def roiaware_pool3d(rois, pts, pts_feature, out_size=(4, 4, 4),
                    max_pts_per_voxel: int = 128, mode: str = "max", device=None):
    """RoI-aware pooling: each box's interior points binned into an
    (ox, oy, oz) grid and max- or mean-pooled.  rois (R, 7); pts (N, 3);
    pts_feature (N, C) -> (R, ox, oy, oz, C)."""
    if mode not in ("max", "avg"):
        raise ValueError(f"roiaware_pool3d: unknown mode {mode!r}")
    rois = _tensor(rois, device)
    pts = _tensor(pts, like=rois)
    feats = _tensor(pts_feature, like=rois)
    ox, oy, oz = out_size
    nvox = ox * oy * oz
    R, N, C = rois.shape[0], pts.shape[0], feats.shape[1]
    dev = rois.device
    grid = _upload(np.array([ox, oy, oz], np.float32), dev)
    top = _upload(np.array([ox - 1, oy - 1, oz - 1], np.float32), dev)
    outs = []
    step = max(1, _POOL_ELEMS // max(N * max(C, 1), 1))
    for s in range(0, R, step):
        roi = rois[s:s + step]
        r = roi.shape[0]
        local = _canonical(pts, roi)                                 # (r, N, 3)
        half = roi[:, None, 3:6] / 2
        inside = (torch.abs(local) < half).all(-1)
        cell = roi[:, None, 3:6] / grid
        ijk = torch.floor((local + half) / cell)
        ijk = torch.minimum(torch.clamp(ijk, min=0), top).long()
        vid = torch.where(inside, (ijk[..., 0] * oy + ijk[..., 1]) * oz + ijk[..., 2], nvox)
        seg = (vid + torch.arange(r, device=dev)[:, None] * (nvox + 1)).reshape(-1)
        order = torch.argsort(seg, stable=True)
        lengths = count_ids(seg, r * (nvox + 1))
        rows = feats[order % N]
        cnt = lengths.reshape(r, nvox + 1, 1)
        if mode == "max":
            pooled = torch.segment_reduce(rows, "max", lengths=lengths, axis=0, unsafe=True)
            pooled = pooled.reshape(r, nvox + 1, C)
            pooled = torch.where(cnt > 0, pooled, torch.zeros_like(pooled))
        else:
            tot = torch.segment_reduce(rows, "sum", lengths=lengths, axis=0, unsafe=True)
            pooled = tot.reshape(r, nvox + 1, C) / torch.clamp(cnt, min=1).to(tot.dtype)
        outs.append(pooled[:, :nvox].reshape(r, ox, oy, oz, C))
    return torch.cat(outs)


def roipoint_pool3d(points, point_features, boxes3d, num_sampled_points: int = 512,
                    device=None):
    """RoI point pooling: per box, the first ``num_sampled_points`` interior
    points (xyz and features), the first hit repeated to pad a short box.
    points (B, N, 3); point_features (B, N, C); boxes3d (B, T, 7) ->
    (pooled (B, T, S, 3 + C), empty_flag (B, T))."""
    points = _tensor(points, device)
    feats = _tensor(point_features, like=points)
    boxes = _tensor(boxes3d, like=points)
    S = num_sampled_points
    B, N, _ = points.shape
    local = _canonical(points, boxes)                                # (B, T, N, 3)
    inside = (torch.abs(local) < boxes[..., None, 3:6] / 2).all(-1)
    ar = torch.arange(N, dtype=torch.int32, device=points.device)
    order = torch.where(inside, ar, N + ar)
    k = min(S, N)
    key, sel = torch.topk(order, k, dim=-1, largest=False, sorted=True)
    sel = torch.where(key < N, sel, sel[..., :1])
    if k < S:          # fewer cloud points than samples: wrap around
        sel = sel.repeat(1, 1, -(-S // k))[..., :S]
    merged = torch.cat([points, feats], -1)                          # (B, N, 3 + C)
    pooled = merged[torch.arange(B, device=points.device)[:, None, None], sel]
    empty = ~inside.any(-1)
    return torch.where(empty[..., None, None], torch.zeros_like(pooled), pooled), empty
