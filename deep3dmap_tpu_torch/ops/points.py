"""Point-cloud ops of the PointNet++ family: KNN, ball query, furthest point
sampling, gather/group and three-NN interpolation (port of
``deep3dmap_tpu/ops/points.py``).

Batched over a leading B axis, on the tensors' device, with no host sync:
``furthest_point_sample`` is a loop of ``npoint`` device steps.  Index
outputs are int64 (torch's index type; JAX's are int32) and equal to JAX's:

- distances are JAX's expanded ``|a|^2 + |b|^2 - 2 a.b`` in float32 (not
  ``torch.cdist``), whose rounding decides near ties.  Each product and sum
  is its own elementwise op, so the card gives the CPU's bits (a 3-deep
  matmul on the card fuses them: 5e-3 apart on the distances of near
  points, and other neighbours at near ties);
- ``knn`` takes the k smallest distances with a stable sort, so equal
  distances keep the lower index first, as ``jax.lax.top_k``
  (``torch.topk`` promises no order among ties);
- ``furthest_point_sample`` starts at index 0 and takes the first maximum.

The gathers are advanced indexing, whose backward is a sorted accumulation
(a fixed order on the card).  Numpy inputs go to ``resolve_device(device)``:
the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from .bbox import _tensor


def _dot3(a, b):
    """``a[..., 0] b[..., 0] + a[..., 1] b[..., 1] + a[..., 2] b[..., 2]``,
    each product and sum rounded apart, left to right: the same bits on
    every device (a matmul or a sum over the last axis may fuse or reorder
    them, and near ties then pick other neighbours)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def square_distance(src, dst, device=None):
    """(B, N, 3) x (B, M, 3) -> (B, N, M) squared L2."""
    src = _tensor(src, device)
    dst = _tensor(dst, like=src)
    cross = _dot3(src[:, :, None, :], dst[:, None, :, :])
    s2 = _dot3(src, src)[..., :, None]
    d2 = _dot3(dst, dst)[..., None, :]
    return s2 + d2 - 2.0 * cross


def knn(k: int, xyz, new_xyz, device=None):
    """The k nearest references of each query: xyz (B, N, 3) references,
    new_xyz (B, M, 3) queries -> (dists (B, M, k), idx (B, M, k)),
    ascending."""
    xyz = _tensor(xyz, device)
    d2 = square_distance(_tensor(new_xyz, like=xyz), xyz)            # (B, M, N)
    d2s, idx = torch.sort(d2, dim=-1, stable=True)
    return torch.sqrt(torch.clamp(d2s[..., :k], min=0.0)), idx[..., :k]


def ball_query(radius: float, nsample: int, xyz, new_xyz, device=None):
    """Up to ``nsample`` reference indices within ``radius`` of each query,
    the first ones in index order; the first found pads the rest (an empty
    ball gives index 0 everywhere)."""
    xyz = _tensor(xyz, device)
    d2 = square_distance(_tensor(new_xyz, like=xyz), xyz)            # (B, M, N)
    r2 = float(np.float32(radius * radius))      # JAX's weakly typed bound
    n = xyz.shape[1]
    ar = torch.arange(n, dtype=torch.int32, device=xyz.device)
    order = torch.where(d2 < r2, ar, n + ar)
    key, sel = torch.topk(order, nsample, dim=-1, largest=False, sorted=True)
    return torch.where(key < n, sel, sel[..., :1])


def furthest_point_sample(xyz, npoint: int, device=None):
    """Iterative furthest point sampling: xyz (B, N, 3) -> idx (B, npoint).
    Keeps each point's squared distance to the chosen set; every step is a
    first-argmax on the device."""
    xyz = _tensor(xyz, device)
    B, N, _ = xyz.shape
    dev = xyz.device
    mind = torch.full((B, N), float("inf"), dtype=xyz.dtype, device=dev)
    sel = torch.zeros((B, npoint), dtype=torch.int64, device=dev)
    last = torch.zeros((B,), dtype=torch.int64, device=dev)
    rows = torch.arange(B, device=dev)
    for i in range(npoint):
        diff = xyz - xyz[rows, last][:, None, :]
        mind = torch.minimum(mind, _dot3(diff, diff))
        sel[:, i] = last
        last = torch.argmax(mind, dim=1)
    return sel


def _gather_cols(points, idx):
    """points (B, C, N), idx (B, ...) -> (B, C, ...) by advanced indexing."""
    B = points.shape[0]
    flat = idx.reshape(B, -1)
    rows = torch.arange(B, device=points.device)[:, None]
    out = points.transpose(1, 2)[rows, flat]                         # (B, M, C)
    return out.transpose(1, 2).reshape(points.shape[:2] + idx.shape[1:])


def gather_points(points, idx, device=None):
    """points (B, C, N), idx (B, M) -> (B, C, M)."""
    points = _tensor(points, device)
    return _gather_cols(points, _tensor(idx, dtype=torch.int64, like=points))


def group_points(points, idx, device=None):
    """points (B, C, N), idx (B, M, K) -> (B, C, M, K)."""
    points = _tensor(points, device)
    return _gather_cols(points, _tensor(idx, dtype=torch.int64, like=points))


def three_nn(unknown, known, device=None):
    """The 3 nearest known points of each unknown point ->
    (dist (B, N, 3), idx (B, N, 3))."""
    return knn(3, known, unknown, device=device)


def three_interpolate(features, idx, weight, device=None):
    """Inverse-distance weighted interpolation: features (B, C, M),
    idx (B, N, 3), weight (B, N, 3) -> (B, C, N)."""
    features = _tensor(features, device)
    gathered = group_points(features, idx)                           # (B, C, N, 3)
    return (gathered * _tensor(weight, like=features)[:, None, :, :]).sum(-1)


def three_interpolate_weights(unknown, known, eps: float = 1e-8, device=None):
    """(idx, normalised inverse squared distance weights) of the 3 nearest
    known points, as PointNet++ uses them."""
    dist, idx = three_nn(unknown, known, device=device)
    recip = 1.0 / torch.clamp(dist * dist, min=eps)
    return idx, recip / recip.sum(-1, keepdim=True)
