"""Box ops: IoU overlaps, (soft-)NMS and rotated IoU on the tensors' device
(the port's copy of ``deep3dmap_tpu/ops/bbox.py``).

The JAX package runs each as ``jnp`` code (no Pallas kernel); the port runs
them as PyTorch ops on the card.  Tensors in, tensors out, on the input's
device; numpy inputs go to ``resolve_device(device)``: the card unless the
caller passes ``device="cpu"``.  The arithmetic is JAX's op for op in
float32, so the keep sets are JAX's:

- ``bbox_overlaps``: one broadcast min/max block.
- ``nms``: JAX's keep rule (a kept box suppresses the later boxes, in stable
  descending score order, whose IoU exceeds the threshold).  The
  suppression matrix is built on the device and packed to bits; one copy to
  the host (the call's one sync) feeds the greedy scan, as JAX builds its
  index list on the host; the kept positions go back to the device.
- ``batched_nms``: the float32 class offset ``max(boxes) + 1``.
- ``soft_nms``: the argmax-first loop on the device over a decay matrix
  built once (each element JAX's per-row decay), five launches a box and
  no sync inside the loop; one sync for the dynamic-length result.
- ``nms_match``: JAX's host grouping on the device's IoU matrix.
- ``box_iou_rotated``: Sutherland-Hodgman clipping with JAX's fixed
  16-vertex buffer and its 1e-12 guard, vectorised over pairs in chunks.
  The corners are taken relative to each pair's first box centre, where
  JAX clips at absolute coordinates: the shoelace products stay small, so
  float32 rounding (and a one-ulp ``cos`` of another device) moves the
  result by ~1e-7, not by ~1e-4 of a small box at COCO coordinates; the
  area sums in one fixed order on every device.  ``nms_rotated`` scans its
  matrix on the host after one copy, as JAX does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["bbox_overlaps", "nms", "batched_nms", "soft_nms", "nms_match",
           "box_iou_rotated", "nms_rotated"]

_NBUF = 16                       # polygon buffer of the rotated clip (JAX's)
_PAIRS_PER_CHUNK = {"cuda": 1 << 20, "cpu": 1 << 15}


def _tensor(x, device=None, dtype=torch.float32, like=None) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor: a tensor stays on its device, anything
    else goes to ``like``'s device or to ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    dev = like.device if like is not None else resolve_device(device)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


def _host(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host as numpy: one copy into pinned memory from the
    card (a pageable copy is several times slower)."""
    if t.device.type != "cuda":
        return t.numpy()
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf.numpy()


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host index array onto ``device`` without a sync (pinned,
    non-blocking on the card)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def bbox_overlaps(bboxes1, bboxes2, mode: str = "iou", aligned: bool = False,
                  offset: int = 0, eps: float = 1e-6, device=None) -> torch.Tensor:
    """Pairwise (or aligned) IoU / IoF between xyxy boxes, float32."""
    assert mode in ("iou", "iof")
    b1 = _tensor(bboxes1, device)
    b2 = _tensor(bboxes2, like=b1)
    area1 = (b1[..., 2] - b1[..., 0] + offset) * (b1[..., 3] - b1[..., 1] + offset)
    area2 = (b2[..., 2] - b2[..., 0] + offset) * (b2[..., 3] - b2[..., 1] + offset)
    if not aligned:
        b1, b2 = b1[:, None, :], b2[None, :, :]
        area1, area2 = area1[:, None], area2[None, :]
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = (rb - lt + offset).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter if mode == "iou" else area1
    return inter / union.clamp(min=eps)


def _pack_rows(m: torch.Tensor) -> np.ndarray:
    """A (n, n) bool matrix as (n, ceil(n / 8)) uint8 bit rows on the host
    (bit j % 8 of byte j // 8), in one copy."""
    bits = m.to(torch.uint8)
    pad = (-m.shape[1]) % 8
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.view(m.shape[0], -1, 8)
    weights = (1 << torch.arange(8, device=m.device)).to(torch.uint8)   # made on the device
    return _host((bits * weights).sum(-1, dtype=torch.uint8))


def _greedy_scan(rows: np.ndarray) -> np.ndarray:
    """Positions the greedy pass keeps, given each position's packed
    suppression row (which later positions it suppresses if kept)."""
    removed = np.zeros(rows.shape[1], np.uint8)
    keep = []
    for i in range(rows.shape[0]):
        if (removed[i >> 3] >> (i & 7)) & 1:
            continue
        keep.append(i)
        removed |= rows[i]
    return np.asarray(keep, np.int64)


def nms(boxes, scores, iou_threshold: float, offset: int = 0, device=None):
    """Greedy NMS.  Returns ``(dets, keep_inds)``: ``dets = [x1, y1, x2, y2,
    score]`` of the survivors in descending score order (ties by index),
    both tensors on the boxes' device."""
    boxes = _tensor(boxes, device)
    scores = _tensor(scores, like=boxes)
    n = boxes.shape[0]
    if n == 0:
        inds = torch.zeros(0, dtype=torch.int64, device=boxes.device)
        return torch.cat([boxes, scores[:, None]], 1), inds
    order = torch.argsort(-scores, stable=True)
    ious = bbox_overlaps(boxes[order], boxes[order], offset=offset)
    later = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu_(1)
    kept = _greedy_scan(_pack_rows((ious > iou_threshold) & later))
    inds = order[_upload(kept, boxes.device)]
    return torch.cat([boxes[inds], scores[inds, None]], 1), inds


def batched_nms(boxes, scores, idxs, iou_threshold: float, class_agnostic: bool = False,
                device=None):
    """Per-class NMS through the coordinate offset (mmcv's ``batched_nms``):
    each class's boxes shifted by ``idx * (max(boxes) + 1)`` in float32."""
    boxes = _tensor(boxes, device)
    if class_agnostic or boxes.shape[0] == 0:
        shifted = boxes
    else:
        max_coord = boxes.max() + 1
        shifted = boxes + (_tensor(idxs, like=boxes) * max_coord)[:, None]
    dets, keep = nms(shifted, _tensor(scores, like=boxes), iou_threshold)
    return torch.cat([boxes[keep], dets[:, 4:5]], 1), keep


def soft_nms(boxes, scores, iou_threshold: float = 0.3, sigma: float = 0.5,
             min_score: float = 1e-3, method: str = "linear", device=None):
    """Soft-NMS (linear / gaussian decay).  Returns ``(dets, inds)`` of the
    boxes whose decayed score stays above ``min_score``, in descending
    decayed score."""
    assert method in ("linear", "gaussian")
    boxes = _tensor(boxes, device)
    scores = _tensor(scores, like=boxes)
    n = boxes.shape[0]
    ious = bbox_overlaps(boxes, boxes)
    # every pair's decay, as JAX computes it row by row: a selected box's
    # row scales the others; rows of boxes already out are never read again
    if method == "linear":
        decay = torch.where(ious > iou_threshold, 1.0 - ious, 1.0)
    else:
        decay = torch.exp(-(ious * ious) / sigma)
    cur = scores.clone()
    new_scores = torch.zeros_like(scores)
    done = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    for _ in range(n):
        # one-element index tensors: a 0-d one would be read on the host
        i = torch.argmax(torch.where(done, -torch.inf, cur)).view(1)
        new_scores.scatter_(0, i, cur.gather(0, i))
        done.scatter_(0, i, True)
        cur = cur * decay.index_select(0, i)[0]
    inds = torch.argsort(-new_scores, stable=True)
    inds = inds[new_scores[inds] > min_score]
    return torch.cat([boxes[inds], new_scores[inds, None]], 1), inds


def nms_match(dets, iou_threshold: float, device=None):
    """Group boxes into suppression clusters (``nms.cpp``'s ``nms_match``):
    each group is [kept box, the boxes it suppressed...], as int64 tensors
    on the dets' device."""
    dets = _tensor(dets, device)
    if dets.numel() == 0:
        return []
    # the IoU matrix and the scores in one copy
    host = _host(torch.cat([bbox_overlaps(dets[:, :4], dets[:, :4]), dets[None, :, 4]]))
    ious = host[:-1]
    order = np.argsort(-host[-1], kind="stable")
    alive = np.ones(len(order), bool)
    groups = []
    for i in order:
        if not alive[i]:
            continue
        alive[i] = False
        hit = alive[order] & (ious[i, order] > iou_threshold)
        members = np.concatenate([[i], order[hit]]).astype(np.int64)
        alive[order[hit]] = False
        groups.append(members)
    flat = _upload(np.concatenate(groups), dets.device)
    return list(torch.split(flat, [len(g) for g in groups]))


# ---------------------------------------------------------------------------
# rotated IoU (box_iou_rotated.cpp): exact polygon clipping, vectorised
# ---------------------------------------------------------------------------

def _rect_corners(boxes: torch.Tensor, origin=None) -> torch.Tensor:
    """(..., 5) cx, cy, w, h, angle (rad) -> (..., 4, 2) corners, CCW,
    relative to ``origin`` (..., 2) when given."""
    cx, cy, w, h, a = boxes.unbind(-1)
    if origin is not None:
        cx, cy = cx - origin[..., 0], cy - origin[..., 1]
    cos, sin = torch.cos(a)[..., None], torch.sin(a)[..., None]
    dx = torch.stack([w, w, -w, -w], -1) * 0.5
    dy = torch.stack([-h, h, h, -h], -1) * 0.5
    x = cx[..., None] + dx * cos - dy * sin
    y = cy[..., None] + dx * sin + dy * cos
    return torch.stack([x, y], -1)


def _clip_halfplane(poly, valid, a, b):
    """Clip (P, 16, 2) polygons (valid vertices a prefix) against the
    half-planes cross(b - a, p - a) >= 0, a and b (P, 2): JAX's
    ``_clip_poly_halfplane`` over a leading batch dimension."""
    P, nbuf = valid.shape
    ax, ay = a[:, 0:1], a[:, 1:2]
    d = (b[:, 0:1] - ax) * (poly[..., 1] - ay) - (b[:, 1:2] - ay) * (poly[..., 0] - ax)
    inside = (d >= 0) & valid
    count = valid.sum(-1, keepdim=True)
    idx = torch.arange(nbuf, device=poly.device).expand(P, nbuf)
    nxt = torch.where(idx == count - 1, 0, (idx + 1) % nbuf)
    d_next = d.gather(1, nxt)
    inside_next = inside.gather(1, nxt)
    pn = poly.gather(1, nxt[..., None].expand(P, nbuf, 2))
    den = d - d_next
    t = d / torch.where(den.abs() < 1e-12, 1e-12, den)
    inter = poly + t[..., None] * (pn - poly)
    emit1 = inside & valid
    emit2 = (inside ^ inside_next) & valid & (idx < count)
    per_slot = emit1.to(poly.dtype) + emit2.to(poly.dtype)
    # the exclusive prefix sum as one small matmul (counts below 2 * 16 are
    # exact in float32; a scan over rows of 16 is slow on the card)
    below = torch.ones(nbuf, nbuf, dtype=poly.dtype, device=poly.device).triu_(1)
    start = (per_slot @ below).to(torch.int64)
    # slot nbuf collects what is not emitted and is dropped
    pos1 = torch.where(emit1, start, nbuf)
    pos2 = torch.where(emit2, start + emit1.to(torch.int64), nbuf)
    out = poly.new_zeros(P, nbuf + 1, 2)
    out_valid = valid.new_zeros(P, nbuf + 1)
    out.scatter_(1, pos1[..., None].expand(P, nbuf, 2), torch.where(emit1[..., None], poly, 0.0))
    out.scatter_(1, pos2[..., None].expand(P, nbuf, 2), torch.where(emit2[..., None], inter, 0.0))
    out_valid.scatter_(1, pos1, emit1)
    out_valid.scatter_(1, pos2, emit2)
    out_valid[:, nbuf] = False
    return out[:, :nbuf], out_valid[:, :nbuf]


def _poly_area(poly, valid):
    P, n = valid.shape
    count = valid.sum(-1, keepdim=True)
    idx = torch.arange(n, device=poly.device).expand(P, n)
    nxt = torch.where(idx == count - 1, 0, idx + 1) % n
    x, y = poly[..., 0], poly[..., 1]
    cross = torch.where(valid, x * y.gather(1, nxt) - x.gather(1, nxt) * y, 0.0)
    total = cross[:, 0]
    for k in range(1, n):          # one fixed order on every device
        total = total + cross[:, k]
    return 0.5 * total.abs()


def _pairs_rotated_iou(b1, b2, mode):
    """IoU of P box pairs (P, 5), the corners taken relative to the first
    box's centre."""
    P = b1.shape[0]
    origin = b1[:, :2]
    c1, c2 = _rect_corners(b1, origin), _rect_corners(b2, origin)
    poly = c1.new_zeros(P, _NBUF, 2)
    poly[:, :4] = c1
    valid = torch.zeros(P, _NBUF, dtype=torch.bool, device=b1.device)
    valid[:, :4] = True
    for i in range(4):
        poly, valid = _clip_halfplane(poly, valid, c2[:, i], c2[:, (i + 1) % 4])
    inter = _poly_area(poly, valid)
    a1 = b1[:, 2] * b1[:, 3]
    a2 = b2[:, 2] * b2[:, 3]
    union = a1 + a2 - inter if mode == "iou" else a1
    return inter / union.clamp(min=1e-6)


def box_iou_rotated(boxes1, boxes2, mode: str = "iou", aligned: bool = False,
                    device=None) -> torch.Tensor:
    """Exact rotated IoU between (cx, cy, w, h, angle-rad) boxes
    (``box_iou_rotated.cpp``); ``aligned=False`` gives the N x M matrix."""
    b1 = _tensor(boxes1, device)
    b2 = _tensor(boxes2, like=b1)
    if aligned:
        return _pairs_rotated_iou(b1, b2, mode)
    N, M = b1.shape[0], b2.shape[0]
    out = b1.new_empty(N, M)
    if N == 0 or M == 0:
        return out
    rows = max(1, _PAIRS_PER_CHUNK.get(b1.device.type, 1 << 15) // M)
    for s in range(0, N, rows):
        e = min(N, s + rows)
        k = e - s
        out[s:e] = _pairs_rotated_iou(b1[s:e, None].expand(k, M, 5).reshape(-1, 5),
                                      b2[None].expand(k, M, 5).reshape(-1, 5), mode).view(k, M)
    return out


def nms_rotated(boxes, scores, iou_threshold: float, device=None):
    """Greedy NMS over rotated boxes (``nms_rotated.cpp``), JAX's scan: in
    stable descending score order, each surviving box is kept and removes
    every box whose IoU with it exceeds the threshold."""
    boxes = _tensor(boxes, device)
    scores = _tensor(scores, like=boxes)
    n = boxes.shape[0]
    # the IoU matrix and the scores in one copy
    host = _host(torch.cat([box_iou_rotated(boxes, boxes), scores[None]]))
    ious = host[:-1]
    order = np.argsort(-host[-1], kind="stable")
    alive = np.ones(n, bool)
    keep = []
    for i in order:
        if not alive[i]:
            continue
        keep.append(int(i))
        alive &= ious[i] <= iou_threshold
        alive[i] = False
    inds = _upload(np.asarray(keep, np.int64), boxes.device)
    return torch.cat([boxes[inds], scores[inds, None]], 1), inds
