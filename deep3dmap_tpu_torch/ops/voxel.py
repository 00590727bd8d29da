"""Hard voxelization, dynamic scatter and points-in-boxes (port of
``deep3dmap_tpu/ops/voxel.py``).

Static shapes, as JAX's: voxel ids are linearised, ordered by one stable
sort, and every voxel is a run of consecutive sorted rows.  ``voxelize``
fills fixed-capacity buffers and returns ``num_voxels`` as a device scalar
(no host sync); ``voxelize_host`` trims on the host (one sync, as JAX's).

TRAP: JAX scatters with ``mode="drop"``: rows past ``max_voxels`` (and
invalid points) go to index ``max_voxels`` and vanish.  ``index_put_`` would
raise on that index, so the buffers here carry one spill row that is sliced
off.  The float sums of ``dynamic_scatter`` add each voxel's rows in their
sorted order (``segment_reduce``), a fixed order on every device, where
``index_add_`` adds with atomics on the card.  Max starts at ``-inf`` and is
zeroed where a voxel is empty.

Numpy inputs go to ``resolve_device(device)``: the card unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from .bbox import _host, _tensor, _upload

_I32_MAX = torch.iinfo(torch.int32).max
_I64_MAX = torch.iinfo(torch.int64).max


def count_ids(idx: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of ``0 .. n-1`` occurs in ``idx`` (int64), without the
    host sync of ``torch.bincount`` on the card; integer sums, so the order
    of the adds does not matter."""
    return torch.zeros(n, dtype=torch.int64, device=idx.device).index_add_(
        0, idx, torch.ones_like(idx))


def _coords_of(points, voxel_size, coors_range):
    dev = points.device
    # host constants uploaded without a sync (pinned, non-blocking)
    vs, lo, hi = (_upload(np.asarray(v, np.float32), dev)
                  for v in (voxel_size, coors_range[:3], coors_range[3:]))
    grid = torch.round((hi - lo) / vs).to(torch.int32)
    cf = torch.floor((points[:, :3] - lo) / vs)
    inside = ((cf >= 0) & (cf < grid)).all(1)
    # out-of-range floats only ever meet ``inside == False``; clamp them
    # before the cast, whose result is undefined there
    c = torch.where(inside[:, None], cf, torch.zeros_like(cf)).to(torch.int32)
    return c, inside, grid


def _segments(lin, sentinel):
    """Stable order of ``lin`` and, over the sorted rows, the start flags,
    the 0-based segment ids and each row's rank within its segment."""
    n = lin.shape[0]
    lin_s, order = torch.sort(lin, stable=True)
    new_seg = torch.ones_like(lin_s, dtype=torch.bool)
    new_seg[1:] = lin_s[1:] != lin_s[:-1]
    seg_id = torch.cumsum(new_seg, 0) - 1
    idx = torch.arange(n, device=lin.device)
    seg_start = torch.cummax(torch.where(new_seg, idx, torch.zeros_like(idx)), 0)[0]
    return order, lin_s != sentinel, new_seg, seg_id, idx - seg_start


def voxelize(points, voxel_size, coors_range, max_points: int = 35,
             max_voxels: int = 20000, device=None):
    """Hard voxelization: points (N, C) with xyz first ->
    (voxels (max_voxels, max_points, C), coors (max_voxels, 3) as zyx,
    num_points_per_voxel (max_voxels,), num_voxels, a 0-d device tensor).
    Points keep their input order within a voxel; voxels come in the order
    of their linear id ``(z * ny + y) * nx + x``."""
    points = _tensor(points, device)
    N, C = points.shape
    c, inside, grid = _coords_of(points, voxel_size, coors_range)
    lin = (c[:, 2] * grid[1] + c[:, 1]) * grid[0] + c[:, 0]
    lin = torch.where(inside, lin, torch.full_like(lin, _I32_MAX))
    order, real, new_seg, seg_id, rank = _segments(lin, _I32_MAX)
    valid_pt = real & (rank < max_points) & (seg_id < max_voxels)
    tgt_v = torch.where(valid_pt, seg_id, max_voxels)
    tgt_p = torch.where(valid_pt, rank, 0)
    voxels = points.new_zeros((max_voxels + 1, max_points, C))
    voxels[tgt_v, tgt_p] = points[order]
    npts = count_ids(tgt_v, max_voxels + 1)[:max_voxels].to(torch.int32)
    valid_seg = new_seg & real & (seg_id < max_voxels)
    coors = torch.full((max_voxels + 1, 3), -1, dtype=torch.int32, device=points.device)
    c_sorted = c[order]
    coors[torch.where(valid_seg, seg_id, max_voxels)] = c_sorted.flip(1)
    num_voxels = valid_seg.sum().to(torch.int32)
    return voxels[:max_voxels], coors[:max_voxels], npts, num_voxels


def dynamic_scatter(feats, coors, reduce_op: str = "mean", max_voxels: int = 20000,
                    device=None):
    """Dynamic voxelization's reduce: feats (N, C), integer coors (N, 3)
    (a negative coordinate marks an invalid point) -> (reduced
    (max_voxels, C), out_coors (max_voxels, 3), counts (max_voxels,)).
    Differentiable in ``feats``."""
    if reduce_op not in ("mean", "max", "sum"):
        raise ValueError(f"dynamic_scatter: unknown reduce_op {reduce_op!r}")
    feats = _tensor(feats, device)
    coors = _tensor(coors, dtype=torch.int32, like=feats)
    valid = (coors >= 0).all(1)
    c = coors.long()
    stride = c.abs().max() + 2
    lin = (c[:, 0] * stride + c[:, 1]) * stride + c[:, 2]
    lin = torch.where(valid, lin, torch.full_like(lin, _I64_MAX))
    order, real, new_seg, seg_id, _ = _segments(lin, _I64_MAX)
    ok = real & (seg_id < max_voxels)
    tgt = torch.where(ok, seg_id, max_voxels)                       # non-decreasing
    lengths = count_ids(tgt, max_voxels + 1)
    counts = lengths[:max_voxels].to(torch.int32)
    f_sorted = feats[order]
    if reduce_op == "max":
        out = torch.segment_reduce(f_sorted, "max", lengths=lengths, axis=0,
                                   unsafe=True)[:max_voxels]
        out = torch.where(counts[:, None] > 0, out, torch.zeros_like(out))
    else:
        out = torch.segment_reduce(f_sorted, "sum", lengths=lengths, axis=0,
                                   unsafe=True)[:max_voxels]
        if reduce_op == "mean":
            out = out / torch.clamp(counts[:, None], min=1)
    first = new_seg & ok
    out_coors = torch.full((max_voxels + 1, 3), -1, dtype=torch.int32, device=feats.device)
    out_coors[torch.where(first, seg_id, max_voxels)] = coors[order]
    return out, out_coors[:max_voxels], counts


def points_in_boxes(points, boxes, device=None):
    """points (B, N, 3), boxes (B, T, 7) ``[cx, cy, cz, dx, dy, dz, yaw]``
    (bottom centre) -> the first box holding each point (B, N), -1 for
    none."""
    points = _tensor(points, device)
    boxes = _tensor(boxes, like=points)
    rel = points[:, :, None, :] - boxes[:, None, :, :3]             # (B, N, T, 3)
    yaw = boxes[:, None, :, 6]
    cos, sin = torch.cos(-yaw), torch.sin(-yaw)
    lx = rel[..., 0] * cos - rel[..., 1] * sin
    ly = rel[..., 0] * sin + rel[..., 1] * cos
    lz = rel[..., 2]
    inside = ((torch.abs(lx) <= boxes[:, None, :, 3] / 2)
              & (torch.abs(ly) <= boxes[:, None, :, 4] / 2)
              & (lz >= 0) & (lz <= boxes[:, None, :, 5]))
    first = torch.argmax(inside.to(torch.uint8), dim=2)
    return torch.where(inside.any(2), first, torch.full_like(first, -1))


def voxelize_host(points, voxel_size, coors_range, max_points: int = 35,
                  max_voxels: int = 20000, device=None):
    """``voxelize`` trimmed to its ``num_voxels`` on the host: numpy
    (voxels, coors, num_points_per_voxel), the shapes the reference's Python
    callers see.  One host sync."""
    voxels, coors, npts, nv = voxelize(points, voxel_size, coors_range,
                                       max_points, max_voxels, device=device)
    nv = int(nv)
    return _host(voxels[:nv]), _host(coors[:nv]), _host(npts[:nv])
