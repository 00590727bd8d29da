"""2-D grid sampling in pixel units, written from indexing ops.

Port of ``deep3dmap_tpu/ops/grid_sample.py::grid_sample_2d``.  Coordinates
are in pixels (pixel i sits at coordinate i).

TRAP: this is not ``F.grid_sample``.  A sample whose continuous coordinate
lies outside [0, W-1] x [0, H-1] is zeroed whole, and the neighbour weights
come from clipped coordinates; ``F.grid_sample(align_corners=True,
padding_mode="zeros")`` blends the in-range neighbours at the border instead.
"""
from __future__ import annotations

import torch


def grid_sample_2d_batch(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                         mode: str = "bilinear") -> torch.Tensor:
    """Sample ``img`` (B, H, W, C) at pixel coords ``x``, ``y`` (B, N).

    Returns (B, N, C), zero where (x, y) lies outside the image.
    """
    B, H, W, C = img.shape
    flat = img.reshape(B * H * W, C)
    base = (torch.arange(B, device=img.device) * (H * W)).reshape(B, 1)
    in_bounds = ((x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1))
    keep = in_bounds[..., None].to(img.dtype)

    def take(yi, xi):
        # advanced indexing, not index_select: its backward accumulates with
        # a sorted, fixed-order index_put_ on the card, not with atomics
        return flat[(base + yi * W + xi).reshape(-1)].reshape(B, -1, C)

    if mode == "nearest":
        # round half to even, as jnp.round; NaN coordinates are out of
        # bounds, so any in-range index serves them
        xi = torch.nan_to_num(torch.round(x)).clamp(0, W - 1).long()
        yi = torch.nan_to_num(torch.round(y)).clamp(0, H - 1).long()
        return take(yi, xi) * keep
    if mode != "bilinear":
        raise ValueError(f"grid_sample_2d: unknown mode {mode!r}")

    x0 = torch.clamp(torch.floor(x), 0, W - 1)
    y0 = torch.clamp(torch.floor(y), 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    wx = (torch.clamp(x, 0, W - 1) - x0)[..., None].to(img.dtype)
    wy = (torch.clamp(y, 0, H - 1) - y0)[..., None].to(img.dtype)
    x0i, x1i = torch.nan_to_num(x0).long(), torch.nan_to_num(x1).long()
    y0i, y1i = torch.nan_to_num(y0).long(), torch.nan_to_num(y1).long()

    # the four corners in one gather, so the backward is one sorted
    # accumulation (a fixed order on the card) instead of four
    v00, v01, v10, v11 = take(torch.cat([y0i, y0i, y1i, y1i], dim=1),
                              torch.cat([x0i, x1i, x0i, x1i], dim=1)).chunk(4, dim=1)
    out = (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
           + v10 * (1 - wx) * wy + v11 * wx * wy)
    return out * keep


def grid_sample_2d(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   mode: str = "bilinear") -> torch.Tensor:
    """Sample ``img`` (H, W, C) at pixel coords ``x``, ``y`` of shape (N,).

    Returns (N, C).  Zeros outside [0, W-1] x [0, H-1].
    """
    return grid_sample_2d_batch(img[None], x[None], y[None], mode=mode)[0]
