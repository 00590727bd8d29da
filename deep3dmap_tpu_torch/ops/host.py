"""Host post-processing of text detection: ``pixel_group`` (PAN) and
``contour_expand`` (PSENet) -- the port's copy of
``deep3dmap_tpu/ops/host.py``.

Breadth-first region growing over small label maps, in numpy on the host,
as JAX's (the reference keeps them on the CPU too).  Tensors are accepted
(a card tensor is copied to the host first); this module imports no torch,
so a worker process can use it without a CUDA context.

Note: contour_expand.cpp's ``kernel_step`` is computed with a no-op
``for_each`` (the lambda's return value is discarded, contour_expand.cpp:53),
so the C++ always reads kernel 0.  This is the *intended* PSENet
progressive-scale expansion, as JAX's.
"""
from __future__ import annotations

from collections import deque

import numpy as np

__all__ = ["pixel_group", "contour_expand"]

_NEIGH = ((-1, 0), (1, 0), (0, -1), (0, 1))


def _np(x):
    """A tensor (on any device) or array-like as numpy, without importing
    torch."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def pixel_group(score, mask, embedding, kernel_label, kernel_contour,
                kernel_region_num: int, distance_threshold: float):
    """Group text pixels around kernel regions by embedding distance
    (pixel_group.cpp:36-119).

    score (H, W) float; mask (H, W) bool; embedding (H, W, D);
    kernel_label (H, W) int32; kernel_contour (H, W) uint8.
    Returns a list of ``kernel_region_num`` lists:
    [mean_confidence, px0, py0, px1, py1, ...] per region (region 0 =
    background, kept empty like the C++)."""
    score = _np(score).astype(np.float32)
    mask = _np(mask).astype(bool)
    embedding = _np(embedding).astype(np.float32)
    label = _np(kernel_label).astype(np.int32)
    contour = _np(kernel_contour).astype(np.uint8)
    H, W = score.shape
    D = embedding.shape[-1]
    thr2 = distance_threshold * distance_threshold

    # mean embedding per kernel region (vectorized over the label map)
    sums = np.zeros((kernel_region_num, D), np.float64)
    counts = np.zeros(kernel_region_num, np.int64)
    pos = label > 0
    np.add.at(sums, label[pos], embedding[pos])
    np.add.at(counts, label[pos], 1)
    means = sums / np.maximum(counts, 1)[:, None]

    # BFS from kernel contour pixels outward through mask by embedding dist
    q = deque((y, x, label[y, x])
              for y, x in zip(*np.nonzero((label > 0) & (contour > 0))))
    while q:
        y, x, l = q.popleft()
        for dy, dx in _NEIGH:
            ty, tx = y + dy, x + dx
            if not (0 <= ty < H and 0 <= tx < W):
                continue
            if not mask[ty, tx] or label[ty, tx] > 0:
                continue
            d = embedding[ty, tx] - means[l]
            if float(d @ d) >= thr2:
                continue
            label[ty, tx] = l
            q.append((ty, tx, l))

    # estimate_confidence (pixel_group.cpp:6-34): per-region mean score +
    # flat [x, y] coordinate list
    out = [[0.0, 0.0] for _ in range(kernel_region_num)]
    for l in range(1, kernel_region_num):
        ys, xs = np.nonzero(label == l)
        if len(ys) == 0:
            continue
        conf = float(score[ys, xs].mean())
        coords = np.empty(2 * len(ys), np.float32)
        coords[0::2] = xs
        coords[1::2] = ys
        out[l] = [conf, float(len(ys))] + coords.tolist()
    return out


def contour_expand(kernel_mask, internal_kernel_label, min_kernel_area: int,
                   kernel_num: int):
    """PSENet progressive scale expansion (contour_expand.cpp kernel_dilate).

    kernel_mask (K, H, W) uint8 — kernels ordered large (0) -> small (K-1);
    internal_kernel_label (H, W) int32 — CC labels on the smallest kernel.
    Regions smaller than min_kernel_area are dropped.  Returns the expanded
    (H, W) label map as a list of rows (C++ return type)."""
    data = _np(kernel_mask).astype(np.uint8)
    label0 = _np(internal_kernel_label).astype(np.int32)
    K, H, W = data.shape
    assert label0.shape == (H, W)

    areas = np.bincount(label0.ravel(), minlength=kernel_num + 1)
    keep = (areas >= min_kernel_area)
    keep[0] = False
    text = np.where(keep[label0], label0, 0).astype(np.int32)

    q = deque((y, x) for y, x in zip(*np.nonzero(text)))
    for kid in range(min(kernel_num, K) - 2, -1, -1):
        layer = data[kid]
        nxt = deque()
        while q:
            y, x = q.popleft()
            l = text[y, x]
            is_edge = True
            for dy, dx in _NEIGH:
                ty, tx = y + dy, x + dx
                if not (0 <= ty < H and 0 <= tx < W):
                    continue
                if layer[ty, tx] == 0 or text[ty, tx] > 0:
                    continue
                text[ty, tx] = l
                q.append((ty, tx))
                is_edge = False
            if is_edge:
                nxt.append((y, x))
        q = nxt
    return [row.tolist() for row in text]
