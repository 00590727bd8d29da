"""RoIAlign, RoIPool and rotated RoIAlign (port of
``deep3dmap_tpu/ops/roi_align.py``), differentiable through autograd.

Every RoI's grid of bilinear samples is one batched gather (JAX's
``vmap``) through ``_sampling.bilinear``, the clamped-bilinear helper that
the deformable ops and ``border_align`` share.  No host sync.

TRAP: the border rule is JAX's, not mmcv's or torchvision's.  A sample whose
coordinate lies outside ``(-1, H) x (-1, W)`` is zeroed; inside that band the
coordinate is clamped into ``[0, H-1] x [0, W-1]`` and sampled there.  So
``torchvision.ops`` and ``F.grid_sample`` (which blend the in-range taps at
the border) are not this op.  ``sampling_ratio <= 0`` is a fixed 2 x 2 grid
per bin (not mmcv's adaptive ``ceil(roi / out)``), and ``aligned=False``
clamps the RoI to at least one pixel a side.

Layout NCHW, as the reference wrappers.  Tensors stay on their device;
numpy inputs go to ``resolve_device(device)``: the card unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import torch

from ._sampling import _pair, bilinear, exact_div, feature_rows
from .bbox import _tensor


def _inputs(input, rois, device, ncols):
    feat = _tensor(input, device)
    rois = _tensor(rois, like=feat)
    if rois.ndim != 2 or rois.shape[1] != ncols:
        raise ValueError(f"rois: (R, {ncols}) wanted, got {tuple(rois.shape)}")
    return feat, rois


def _sample_rois(feat, b, yy, xx):
    """Samples (R, C, *yy.shape[1:]) of RoI r's image ``b[r]``."""
    N, C, H, W = feat.shape
    plane = b.reshape((-1,) + (1,) * (yy.ndim - 1))
    return bilinear(feature_rows(feat), H, W, plane, yy, xx).movedim(-1, 1)


def roi_align(input, rois, output_size, spatial_scale: float = 1.0,
              sampling_ratio: int = 0, aligned: bool = True, device=None):
    """input (N, C, H, W), rois (R, 5) ``[batch_idx, x1, y1, x2, y2]`` ->
    (R, C, out_h, out_w): the mean of ``s x s`` samples per bin
    (``s = sampling_ratio``, 2 when it is <= 0)."""
    feat, rois = _inputs(input, rois, device, 5)
    out_h, out_w = _pair(output_size)
    s = sampling_ratio if sampling_ratio > 0 else 2
    offset = 0.5 if aligned else 0.0
    b = rois[:, 0].long()
    x1, y1, x2, y2 = (rois[:, i] * spatial_scale - offset for i in range(1, 5))
    rw, rh = x2 - x1, y2 - y1
    if not aligned:
        rw, rh = torch.clamp(rw, min=1.0), torch.clamp(rh, min=1.0)
    bin_w, bin_h = exact_div(rw, out_w), exact_div(rh, out_h)
    dev = feat.device
    gy = y1[:, None] + exact_div((torch.arange(out_h * s, device=dev) + 0.5) * bin_h[:, None], s)
    gx = x1[:, None] + exact_div((torch.arange(out_w * s, device=dev) + 0.5) * bin_w[:, None], s)
    samples = _sample_rois(feat, b, gy[:, :, None], gx[:, None, :])
    R, C = samples.shape[:2]
    return samples.reshape(R, C, out_h, s, out_w, s).mean((3, 5))


def roi_pool(input, rois, output_size, spatial_scale: float = 1.0, device=None):
    """Max RoI pooling over a dense 4 x 4 grid of bilinear samples per bin;
    the gradient of a tied maximum is shared evenly (``amax``), as JAX's."""
    feat, rois = _inputs(input, rois, device, 5)
    out_h, out_w = _pair(output_size)
    s = 4
    b = rois[:, 0].long()
    x1, y1, x2, y2 = (torch.round(rois[:, i] * spatial_scale) for i in range(1, 5))
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    dev = feat.device
    gy = y1[:, None] + exact_div((torch.arange(out_h * s, device=dev) + 0.5) * rh[:, None],
                                 out_h * s) - 0.5
    gx = x1[:, None] + exact_div((torch.arange(out_w * s, device=dev) + 0.5) * rw[:, None],
                                 out_w * s) - 0.5
    samples = _sample_rois(feat, b, gy[:, :, None], gx[:, None, :])
    R, C = samples.shape[:2]
    return samples.reshape(R, C, out_h, s, out_w, s).amax((3, 5))


def roi_align_rotated(input, rois, output_size, spatial_scale: float = 1.0,
                      sampling_ratio: int = 0, aligned: bool = True,
                      clockwise: bool = False, device=None):
    """Rotated RoIAlign: rois (R, 6) ``[batch_idx, cx, cy, w, h, angle]``
    (radians) -> (R, C, out_h, out_w)."""
    feat, rois = _inputs(input, rois, device, 6)
    out_h, out_w = _pair(output_size)
    s = sampling_ratio if sampling_ratio > 0 else 2
    offset = 0.5 if aligned else 0.0
    b = rois[:, 0].long()
    cx = rois[:, 1] * spatial_scale - offset
    cy = rois[:, 2] * spatial_scale - offset
    w = rois[:, 3] * spatial_scale
    h = rois[:, 4] * spatial_scale
    theta = -rois[:, 5] if clockwise else rois[:, 5]
    if not aligned:
        w, h = torch.clamp(w, min=1.0), torch.clamp(h, min=1.0)
    dev = feat.device
    gy = (torch.arange(out_h * s, device=dev) + 0.5) * exact_div(h[:, None], out_h * s) - h[:, None] / 2
    gx = (torch.arange(out_w * s, device=dev) + 0.5) * exact_div(w[:, None], out_w * s) - w[:, None] / 2
    yy, xx = gy[:, :, None], gx[:, None, :]
    cos, sin = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    ry = yy * cos + xx * sin + cy[:, None, None]
    rx = xx * cos - yy * sin + cx[:, None, None]
    samples = _sample_rois(feat, b, ry, rx)
    R, C = samples.shape[:2]
    return samples.reshape(R, C, out_h, s, out_w, s).mean((3, 5))
