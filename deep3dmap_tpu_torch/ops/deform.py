"""Deformable sampling ops: deformable conv v1/v2, deformable RoI pooling
and multi-scale deformable attention (port of ``deep3dmap_tpu/ops/deform.py``).

The same algebra as JAX's: the deformed taps are gathered into im2col
columns ``(N, C, kh*kw, Ho*Wo)`` with the clamped bilinear rule of
``_sampling.bilinear`` (one gather for every tap, group and image), then one
batched GEMM per conv group.  Differentiable through autograd; the gathers'
backward is a sorted accumulation (a fixed order on the card).  No host sync.

TRAP: the GEMM is a float32 matmul, which the card runs in TF32 when
``torch.backends.cuda.matmul.allow_tf32`` is on; hold it against float32
under ``utils.device.no_tf32``.

Layout NCHW.  Tensors stay on their device; numpy inputs go to
``resolve_device(device)``: the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import torch

from .bbox import _tensor
from ._sampling import _pair, bilinear, exact_div, feature_rows


def _columns(x, offset, mask, kernel_size, stride, padding, dilation, deform_groups):
    """x (N, C, H, W), offset (N, 2*dg*kh*kw, Ho, Wo) as (dy, dx) pairs,
    mask (N, dg*kh*kw, Ho, Wo) or None -> columns (N, C, kh*kw, Ho*Wo)."""
    kh, kw = kernel_size
    N, C, H, W = x.shape
    Ho, Wo = offset.shape[-2:]
    dg, K = deform_groups, kh * kw
    dev = x.device
    off = offset.reshape(N, dg, K, 2, Ho, Wo)
    k = torch.arange(K, device=dev)
    ky = (k // kw * dilation[0]).reshape(K, 1, 1)
    kx = (k % kw * dilation[1]).reshape(K, 1, 1)
    base_y = (torch.arange(Ho, device=dev) * stride[0] - padding[0]).reshape(Ho, 1)
    base_x = (torch.arange(Wo, device=dev) * stride[1] - padding[1]).reshape(1, Wo)
    y = (base_y + torch.zeros((1, Wo), device=dev)) + ky + off[:, :, :, 0]   # (N, dg, K, Ho, Wo)
    xx = (base_x + torch.zeros((Ho, 1), device=dev)) + kx + off[:, :, :, 1]
    plane = torch.arange(N * dg, device=dev).reshape(N, dg, 1, 1, 1)
    cols = bilinear(feature_rows(x.reshape(N, dg, C // dg, H, W)), H, W, plane, y, xx)
    if mask is not None:
        cols = cols * mask.reshape(N, dg, K, Ho, Wo)[..., None]
    # (N, dg, K, Ho, Wo, cg) -> (N, C, K, Ho*Wo), channel g*cg + c
    return cols.permute(0, 1, 5, 2, 3, 4).reshape(N, C, K, Ho * Wo)


def _deform_conv(x, offset, mask, weight, stride, padding, dilation, groups, deform_groups):
    kh, kw = weight.shape[-2:]
    cols = _columns(x, offset, mask, (kh, kw), _pair(stride), _pair(padding),
                    _pair(dilation), deform_groups)
    N, C, K, L = cols.shape
    cout = weight.shape[0]
    cols = cols.reshape(N, groups, (C // groups) * K, L)
    w = weight.reshape(groups, cout // groups, (C // groups) * kh * kw)
    Ho, Wo = offset.shape[-2:]
    return torch.matmul(w, cols).reshape(N, cout, Ho, Wo)


def deform_conv2d(x, offset, weight, stride=1, padding=0, dilation=1,
                  groups: int = 1, deform_groups: int = 1, device=None):
    """Deformable convolution v1: x (N, C, H, W); offset
    (N, 2*dg*kh*kw, Ho, Wo) as (dy, dx) pairs; weight (Cout, C/groups, kh, kw)
    -> (N, Cout, Ho, Wo)."""
    x = _tensor(x, device)
    return _deform_conv(x, _tensor(offset, like=x), None, _tensor(weight, like=x),
                        stride, padding, dilation, groups, deform_groups)


def modulated_deform_conv2d(x, offset, mask, weight, bias=None, stride=1,
                            padding=0, dilation=1, groups: int = 1,
                            deform_groups: int = 1, device=None):
    """Modulated deformable convolution v2: v1 with a scalar mask per tap,
    mask (N, dg*kh*kw, Ho, Wo), and an optional bias."""
    x = _tensor(x, device)
    out = _deform_conv(x, _tensor(offset, like=x), _tensor(mask, like=x),
                       _tensor(weight, like=x), stride, padding, dilation, groups,
                       deform_groups)
    if bias is not None:
        out = out + _tensor(bias, like=x)[None, :, None, None]
    return out


def deform_roi_pool(input, rois, offset, output_size, spatial_scale=1.0,
                    sampling_ratio: int = 2, gamma: float = 0.1, device=None):
    """Deformable RoI pooling: RoIAlign whose bins move by
    ``gamma * (roi size) * offset``.  input (N, C, H, W); rois (R, 5)
    ``[b, x1, y1, x2, y2]``; offset (R, 2, out_h, out_w) or None ->
    (R, C, out_h, out_w)."""
    feat = _tensor(input, device)
    rois = _tensor(rois, like=feat)
    oh, ow = _pair(output_size)
    sr = max(sampling_ratio, 1)
    H, W = feat.shape[-2:]
    dev = feat.device
    b = rois[:, 0].long()
    x1, y1, x2, y2 = (rois[:, i] * spatial_scale for i in range(1, 5))
    rw = torch.clamp(x2 - x1, min=1.0)
    rh = torch.clamp(y2 - y1, min=1.0)
    bw, bh = exact_div(rw, ow), exact_div(rh, oh)
    sy = exact_div(torch.arange(sr, device=dev) + 0.5, sr)
    ys = y1[:, None, None] + (torch.arange(oh, device=dev)[:, None] + sy[None, :]) * bh[:, None, None]
    xs = x1[:, None, None] + (torch.arange(ow, device=dev)[:, None] + sy[None, :]) * bw[:, None, None]
    R = rois.shape[0]
    y = ys[:, :, None, :, None] + torch.zeros((1, 1, ow, 1, sr), device=dev)   # (R, oh, ow, sr, sr)
    x = xs[:, None, :, None, :] + torch.zeros((1, oh, 1, sr, 1), device=dev)
    if offset is not None:
        off = _tensor(offset, like=feat)
        y = y + (gamma * rh)[:, None, None, None, None] * off[:, 1, :, :, None, None]
        x = x + (gamma * rw)[:, None, None, None, None] * off[:, 0, :, :, None, None]
    vals = bilinear(feature_rows(feat), H, W, b.reshape(R, 1, 1, 1, 1), y, x)
    return vals.mean((-2, -3)).movedim(-1, 1)


def ms_deform_attn(value, spatial_shapes, level_start_index, sampling_locations,
                   attention_weights, device=None):
    """Multi-scale deformable attention (Deformable DETR).

    value (N, Lv, heads, C); spatial_shapes (L, 2) ``(H, W)`` per level and
    level_start_index (L,), host integers (a device tensor costs one copy
    for both, not one per level); sampling_locations (N, Lq, heads, L, P, 2)
    in [0, 1]; attention_weights (N, Lq, heads, L, P) -> (N, Lq, heads*C).
    Samples at ``loc * (W, H) - 0.5`` (the kernel's align_corners=False)."""
    value = _tensor(value, device)
    loc_all = _tensor(sampling_locations, like=value)
    attn = _tensor(attention_weights, like=value)
    tensors = [t for t in (spatial_shapes, level_start_index) if isinstance(t, torch.Tensor)]
    if tensors:
        dev = tensors[0].device
        both = torch.cat([torch.as_tensor(t, device=dev).reshape(-1).long()
                          for t in (spatial_shapes, level_start_index)]).tolist()
        L = len(both) // 3
        shapes = [(int(both[2 * i]), int(both[2 * i + 1])) for i in range(L)]
        starts = [int(s) for s in both[2 * L:]]
    else:
        shapes = [(int(h), int(w)) for h, w in spatial_shapes]
        starts = [int(s) for s in level_start_index]
    N, _, nh, C = value.shape
    Lq = loc_all.shape[1]
    plane = torch.arange(N * nh, device=value.device).reshape(N, nh, 1, 1)
    out = torch.zeros((N, nh, Lq, C), dtype=value.dtype, device=value.device)
    for lvl, (H, W) in enumerate(shapes):
        v = value[:, starts[lvl]:starts[lvl] + H * W]                   # (N, HW, nh, C)
        rows = v.permute(0, 2, 1, 3).reshape(N * nh * H * W, C)
        loc = loc_all[:, :, :, lvl].transpose(1, 2)                     # (N, nh, Lq, P, 2)
        x = loc[..., 0] * W - 0.5
        y = loc[..., 1] * H - 0.5
        sampled = bilinear(rows, H, W, plane, y, x)                     # (N, nh, Lq, P, C)
        w = attn[:, :, :, lvl].transpose(1, 2)                          # (N, nh, Lq, P)
        out = out + (sampled * w[..., None]).sum(3)
    return out.permute(0, 2, 1, 3).reshape(N, Lq, nh * C)
