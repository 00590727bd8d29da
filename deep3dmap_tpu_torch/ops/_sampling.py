"""The clamped bilinear gather shared by the RoI ops, the deformable ops
and ``border_align`` (JAX's ``_bilinear`` of ``ops/roi_align.py``,
``_bilinear_chw`` of ``ops/deform.py`` and ``_bilinear_nchw`` of
``ops/vision.py``, which are one function).

The feature map is laid out as rows of C channels; the four taps of every
sample are read in one advanced-indexing gather, whose backward is one
sorted accumulation (a fixed order on the card).
"""
from __future__ import annotations

import torch


def exact_div(t: torch.Tensor, d) -> torch.Tensor:
    """``t / d`` rounded once, as on the CPU and in JAX, on every device.
    The card divides by a Python number as a product with its float32
    reciprocal, which can be an ulp off: enough to move a sample across a
    tap or to break a tie of a max.  A 0-d tensor on the device divides."""
    if not isinstance(d, torch.Tensor):
        d = torch.full((), float(d), dtype=t.dtype, device=t.device)
    return t / d


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def feature_rows(feat: torch.Tensor) -> torch.Tensor:
    """(..., C, H, W) -> (prod(...) * H * W, C): the gather table of
    ``bilinear``, one row of channels per pixel of every plane."""
    C, H, W = feat.shape[-3:]
    return feat.movedim(-3, -1).reshape(-1, C)


def bilinear(rows: torch.Tensor, H: int, W: int, plane: torch.Tensor,
             y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Clamped bilinear samples of the planes of ``rows``
    (``feature_rows``): sample ``(y, x)`` reads plane ``plane`` (an index
    broadcastable to ``y``).  Returns ``(*y.shape, C)``.

    JAX's ``_bilinear``: zero outside ``(-1, H) x (-1, W)``, the coordinate
    clamped into the image inside that band, the weights
    ``(1-ly)(1-lx), (1-ly)lx, ly(1-lx), ly lx``."""
    valid = (y > -1.0) & (y < H) & (x > -1.0) & (x < W)
    y = torch.clamp(y, 0.0, H - 1)
    x = torch.clamp(x, 0.0, W - 1)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    ly, lx = y - y0, x - x0
    hy, hx = 1.0 - ly, 1.0 - lx
    base = plane * (H * W)
    # a NaN coordinate is invalid: any in-range row serves it
    y0i, x0i = torch.nan_to_num(y0).long(), torch.nan_to_num(x0).long()
    y1i, x1i = torch.nan_to_num(y1).long(), torch.nan_to_num(x1).long()
    idx = torch.stack(torch.broadcast_tensors(base + y0i * W + x0i, base + y0i * W + x1i,
                                              base + y1i * W + x0i, base + y1i * W + x1i))
    g = rows[idx.reshape(-1)].reshape(*idx.shape, rows.shape[-1])
    out = (g[0] * (hy * hx)[..., None] + g[1] * (hy * lx)[..., None]
           + g[2] * (ly * hx)[..., None] + g[3] * (ly * lx)[..., None])
    return out * valid[..., None]
