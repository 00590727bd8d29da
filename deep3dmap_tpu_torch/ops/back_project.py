"""Dense/sparse multi-view back-projection, the NeuralRecon hot op.

Port of ``deep3dmap_tpu/ops/back_project.py``.  All V views'
feature maps are flattened into one table whose rows pack each pixel's 2x2
bilinear neighbourhood (4C channels, edge-replicated shifts reproduce the
clamped x+1/y+1 taps exactly), and every (voxel, view) pair reads one row.

Semantics of the reference:
  - voxel world position = coord * voxel_size + origin
  - per-view 4x4 projection (intrinsics pre-scaled per level)
  - bilinear sampling, zeros padding, align_corners=True
  - validity: pixel inside the image and depth z > 0
  - feature = mean over valid views; an extra channel holds the per-voxel
    mean camera depth, standardised over the seen voxels
  - count = number of views seeing the voxel

TRAP: ``NeuralReconNet.bp_gather_dtype`` defaults to bfloat16 and
``NeuralRecon`` never overrides it, so the gather table is bf16 on every
path, fp32 configs included.  The cast happens where the JAX code casts
(before the table is built) and the taps accumulate in float32.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils import tracing
from .block_sparse import first_nonzero


def _voxel_world_from_flat(flat_idx: torch.Tensor, dim: int, voxel_size: float,
                           origin: torch.Tensor, interval: int) -> torch.Tensor:
    """World centres for voxels given by linear indices into a dim³ grid."""
    ix = flat_idx // (dim * dim)
    iy = (flat_idx // dim) % dim
    iz = flat_idx % dim
    coords = torch.stack([ix, iy, iz], dim=-1).to(torch.float32) * interval
    return coords * voxel_size + origin


class _PackedGather(torch.autograd.Function):
    """Rows of a segment-major table, with the per-view scatter backward of
    the JAX ``_packed_gather`` (``back_project.py:34-116``).

    The table is S segments of ``hw`` rows (one per (batch, view)); row
    ``local[s, k]`` of segment s is read.  Local indices are clamped into
    [0, hw - 1] for the gather and the scatter alike, as JAX's
    ``mode="clip"`` keeps a NaN pose's index in bounds (a bare
    ``index_select`` raises on the CPU and asserts on the card).  The
    backward adds the cotangent rows into zeros in the cotangent's dtype
    (bf16 with the default gather table), as JAX's per-segment scatter does;
    segments are disjoint, so one flat scatter-add over all of them gives
    each segment's sums with one call instead of S.  The scatter is
    ``index_put_(accumulate=True)``, which sorts the rows and adds each
    row's terms in a fixed order on the card (``index_add_`` there takes
    atomics, whose order changes from run to run).

    ``BP_GRAD_FRAC`` (JAX's ``grad_row_frac``) is accepted by
    ``NeuralRecon`` as a no-op: JAX compacts each segment's valid rows
    because the TPU's scatter is bound by its row rate, and its gradient is
    this full scatter's (invalid rows carry zero cotangents).  The sorted
    ``index_put_`` here takes all rows in one call either way.
    """

    @staticmethod
    def forward(ctx, table, local, hw):
        S = local.shape[0]
        base = (torch.arange(S, device=local.device) * hw)[:, None]
        rows = (local.clamp(0, hw - 1) + base).reshape(-1)
        ctx.save_for_backward(rows)
        ctx.n_rows = table.shape[0]
        return table.index_select(0, rows)

    @staticmethod
    def backward(ctx, d_out):
        (rows,) = ctx.saved_tensors
        d_table = d_out.new_zeros((ctx.n_rows, d_out.shape[-1]))
        d_table.index_put_((rows,), d_out, accumulate=True)
        return d_table, None, None


def _packed_gather(table: torch.Tensor, local: torch.Tensor,
                   hw: int) -> torch.Tensor:
    """table (S*hw, C), local (S, K) row indices within each segment ->
    (S*K, C), differentiable in ``table``."""
    return _PackedGather.apply(table, local, hw)


def back_project_sparse_batch(feats: torch.Tensor, proj: torch.Tensor,
                              origin: torch.Tensor, flat_idx: torch.Tensor,
                              slot_valid: torch.Tensor, dim: int,
                              voxel_size: float, interval: int,
                              gather_dtype: Optional[torch.dtype] = None):
    """Back-project K voxels per batch element against all views.

    Args:
        feats: (B, V, H, W, C) per-view feature maps.
        proj: (B, V, 4, 4) projection matrices at this level.
        origin: (B, 3) world position of voxel (0, 0, 0).
        flat_idx: (B, K) linear voxel indices (padded).
        slot_valid: (B, K) bool, False for padding slots.

    Returns:
        features (B, K, C + 1): mean features + normalised-depth channel.
        count (B, K): number of views seeing each voxel.
    """
    B, V, H, W, C = feats.shape
    K = flat_idx.shape[1]
    world = _voxel_world_from_flat(flat_idx, dim, voxel_size,
                                   origin[:, None, :], interval)      # (B,K,3)
    homo = torch.cat([world, torch.ones_like(world[..., :1])], dim=-1)
    cam = torch.einsum("bkj,bvij->bvki", homo, proj)                 # (B,V,K,4)
    z = cam[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-6, z, torch.full_like(z, 1e-6))
    px = cam[..., 0] / safe_z
    py = cam[..., 1] / safe_z

    valid = ((px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1) & (z > 0)
             & slot_valid[:, None, :])

    x0 = torch.clamp(torch.floor(px), 0, W - 1)
    y0 = torch.clamp(torch.floor(py), 0, H - 1)
    wx = torch.clamp(px, 0, W - 1) - x0
    wy = torch.clamp(py, 0, H - 1) - y0

    if gather_dtype is not None:
        feats = feats.to(gather_dtype)
    f_x1 = torch.cat([feats[:, :, :, 1:], feats[:, :, :, -1:]], dim=3)
    f_y1 = torch.cat([feats[:, :, 1:], feats[:, :, -1:]], dim=2)
    f_y1x1 = torch.cat([f_y1[:, :, :, 1:], f_y1[:, :, :, -1:]], dim=3)
    table = torch.cat([feats, f_x1, f_y1, f_y1x1],
                      dim=-1).reshape(B * V * H * W, 4 * C)
    # a NaN pose gives NaN taps: the pixel index becomes 0 (XLA converts
    # NaN to 0; a bare cast gives INT64_MIN) and its features stay NaN
    local = (torch.nan_to_num(y0).to(torch.int64) * W
             + torch.nan_to_num(x0).to(torch.int64))                  # (B,V,K)
    g = _packed_gather(table, local.reshape(B * V, K),
                       H * W).reshape(B, V, K, 4 * C)
    f = (g[..., 0 * C:1 * C].float() * ((1 - wx) * (1 - wy))[..., None]
         + g[..., 1 * C:2 * C].float() * (wx * (1 - wy))[..., None]
         + g[..., 2 * C:3 * C].float() * ((1 - wx) * wy)[..., None]
         + g[..., 3 * C:4 * C].float() * (wx * wy)[..., None])

    vf = valid.to(f.dtype)                                           # (B,V,K)
    f = f * vf[..., None]
    zv = z * vf

    count = vf.sum(dim=1)                                            # (B,K)
    denom = torch.clamp(count, min=1.0)
    mean_f = f.sum(dim=1) / denom[..., None]
    mean_z = zv.sum(dim=1) / denom

    # standardise mean depth over seen voxels, per batch element
    # (reference back_project.py:76-80)
    seen = mean_z > 0
    zero = torch.zeros_like(mean_z)
    n_seen = torch.clamp(seen.sum(dim=1), min=1)
    z_mean = torch.where(seen, mean_z, zero).sum(dim=1) / n_seen
    z_var = torch.where(seen, (mean_z - z_mean[:, None]) ** 2, zero).sum(dim=1)
    z_std = torch.sqrt(z_var) + 1e-5
    z_norm = torch.where(seen, (mean_z - z_mean[:, None]) / z_std[:, None], zero)

    features = torch.cat([mean_f, z_norm[..., None]], dim=-1)
    return features, count


def back_project_batch(feats, proj, origin, dim: int, voxel_size: float,
                       interval: int, gather_dtype=None):
    """Dense wrapper: all dim³ voxels.  Returns volume (B, d, d, d, C+1) and
    count (B, d, d, d)."""
    B, C = feats.shape[0], feats.shape[-1]
    N = dim ** 3
    flat_idx = torch.arange(N, device=feats.device).expand(B, N)
    valid = torch.ones((B, N), dtype=torch.bool, device=feats.device)
    f, cnt = back_project_sparse_batch(feats, proj, origin, flat_idx, valid,
                                       dim, voxel_size, interval,
                                       gather_dtype=gather_dtype)
    return (f.reshape(B, dim, dim, dim, C + 1),
            cnt.reshape(B, dim, dim, dim))


def back_project_masked_batch(feats, proj, origin, mask, capacity: int,
                              dim: int, voxel_size: float, interval: int,
                              gather_dtype=None, count_as: Optional[str] = None):
    """Sparse-capacity back-projection: up to ``capacity`` active voxels of
    ``mask`` (B, d, d, d) per batch element, scattered back into dense
    volume/count arrays.  ``count_as`` names the counter of each row's
    active voxels against ``capacity`` (``utils/tracing.py``)."""
    B, C = feats.shape[0], feats.shape[-1]
    N = dim ** 3
    flat_idx, n_active = first_nonzero(mask.reshape(B, N), capacity)
    if count_as is not None:
        tracing.count(count_as, n_active, cap=capacity)
    slot_valid = (torch.arange(capacity, device=feats.device)[None, :]
                  < n_active[:, None])
    f, cnt = back_project_sparse_batch(feats, proj, origin, flat_idx,
                                       slot_valid, dim, voxel_size, interval,
                                       gather_dtype=gather_dtype)
    vf = slot_valid.to(f.dtype)
    rows = (flat_idx + (torch.arange(B, device=feats.device) * N)[:, None]).reshape(-1)
    # real rows are unique; padding rows add exact zeros.  Sorted
    # accumulation keeps the order fixed on the card (see _PackedGather)
    volume = torch.zeros((B * N, C + 1), dtype=f.dtype, device=f.device)
    volume.index_put_((rows,), (f * vf[..., None]).reshape(B * capacity, C + 1),
                      accumulate=True)
    count = torch.zeros((B * N,), dtype=cnt.dtype, device=cnt.device)
    count.index_put_((rows,), (cnt * vf).reshape(-1), accumulate=True)
    return (volume.reshape(B, dim, dim, dim, C + 1),
            count.reshape(B, dim, dim, dim))


def back_project_sparse(feats, proj, origin, flat_idx, slot_valid, dim: int,
                        voxel_size: float, interval: int, gather_dtype=None):
    """One batch element: feats (V, H, W, C), proj (V, 4, 4), origin (3,),
    flat_idx (K,), slot_valid (K,) -> features (K, C + 1), count (K,)."""
    f, cnt = back_project_sparse_batch(feats[None], proj[None], origin[None], flat_idx[None],
                                       slot_valid[None], dim, voxel_size, interval,
                                       gather_dtype=gather_dtype)
    return f[0], cnt[0]


def back_project_dense(feats, proj, origin, dim: int, voxel_size: float, interval: int,
                       gather_dtype=None):
    """One batch element, all dim³ voxels: volume (d, d, d, C + 1), count
    (d, d, d)."""
    vol, cnt = back_project_batch(feats[None], proj[None], origin[None], dim, voxel_size,
                                  interval, gather_dtype=gather_dtype)
    return vol[0], cnt[0]


def back_project_masked(feats, proj, origin, mask, capacity: int, dim: int,
                        voxel_size: float, interval: int, gather_dtype=None):
    """One batch element, up to ``capacity`` active voxels of ``mask``
    (d, d, d): volume (d, d, d, C + 1), count (d, d, d)."""
    vol, cnt = back_project_masked_batch(feats[None], proj[None], origin[None], mask[None],
                                         capacity, dim, voxel_size, interval,
                                         gather_dtype=gather_dtype)
    return vol[0], cnt[0]
