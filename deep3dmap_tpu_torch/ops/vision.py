"""Dense-vision ops: CARAFE, masked conv, correlation, TIN shift, PSA mask,
border align and corner pool (port of ``deep3dmap_tpu/ops/vision.py``).

JAX's static gathers, rolls and scans, on the tensors' device with no host
sync; gradients come from autograd and every gather is advanced indexing,
whose backward is a sorted accumulation (a fixed order on the card).

TRAP: ``masked_conv2d`` is a cuDNN convolution on the card, which runs in
TF32 when ``torch.backends.cudnn.allow_tf32`` is on (the default); hold it
against float32 under ``utils.device.no_tf32``.  ``correlation`` rolls with
wrap-around and masks only the displaced image, as JAX's does: the rolls of
a kernel window wider than 1 wrap at the border.

Layout NCHW.  Numpy inputs go to ``resolve_device(device)``: the card unless
the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .bbox import _tensor
from ._sampling import bilinear, exact_div, feature_rows


def carafe(features, masks, kernel_size: int = 5, group_size: int = 1,
           scale_factor: int = 2, device=None):
    """CARAFE reassembly: features (N, C, H, W); masks
    (N, group*k*k, sH, sW), a normalised k x k kernel per output pixel ->
    (N, C, sH, sW), the mask-weighted sum of the k x k source neighbourhood
    centred at ``(i // s, j // s)``."""
    features = _tensor(features, device)
    masks = _tensor(masks, like=features)
    N, C, H, W = features.shape
    s, k = scale_factor, kernel_size
    r = k // 2
    sH, sW = H * s, W * s
    g, cg = group_size, C // group_size
    dev = features.device
    oy = torch.arange(sH, device=dev) // s
    ox = torch.arange(sW, device=dev) // s
    m = masks.reshape(N, g, 1, k * k, sH, sW)
    out = features.new_zeros((N, g, cg, sH, sW))
    for t in range(k * k):
        dy, dx = divmod(t, k)
        yy = oy + (dy - r)
        xx = ox + (dx - r)
        valid = (((yy >= 0) & (yy < H))[:, None] & ((xx >= 0) & (xx < W))[None]).to(features.dtype)
        src = features[:, :, yy.clamp(0, H - 1)[:, None], xx.clamp(0, W - 1)[None, :]]
        out = out + src.reshape(N, g, cg, sH, sW) * m[:, :, :, t] * valid
    return out.reshape(N, C, sH, sW)


def carafe_naive(features, masks, kernel_size: int = 5, group_size: int = 1,
                 scale_factor: int = 2, device=None):
    """The same map as ``carafe`` (the reference's naive kernel)."""
    return carafe(features, masks, kernel_size, group_size, scale_factor, device=device)


def masked_conv2d(x, mask, weight, bias=None, padding: int = 1, device=None):
    """A stride-1 conv kept where ``mask > 0`` and zero elsewhere: x
    (N, C, H, W); mask (N, H, W); weight (Cout, C, kh, kw).  The dense conv
    everywhere, then the select, as JAX's."""
    x = _tensor(x, device)
    mask = _tensor(mask, like=x)
    out = F.conv2d(x, _tensor(weight, like=x), None, padding=padding)
    if bias is not None:
        out = out + _tensor(bias, like=x)[None, :, None, None]
    return out * (mask[:, None] > 0)


def correlation(input1, input2, kernel_size: int = 1, max_displacement: int = 1,
                stride: int = 1, padding: int = 0, dilation: int = 1,
                dilation_patch: int = 1, device=None):
    """FlowNet correlation -> (N, pH, pW, oH, oW), ``patch = 2 d + 1``:
    ``out[n, pi, pj, i, j] = sum_{c,u,v} I1[n, c, y+u, x+v] *
    I2[n, c, y+u+dy, x+v+dx]``, (dy, dx) the displacement times
    ``dilation_patch``."""
    input1 = _tensor(input1, device)
    input2 = _tensor(input2, like=input1)
    N, C, H, W = input1.shape
    k, d = kernel_size, max_displacement
    patch = 2 * d + 1
    pad = padding
    x1 = F.pad(input1, (pad, pad, pad, pad))
    x2 = F.pad(input2, (pad, pad, pad, pad))
    Hp, Wp = x1.shape[-2:]
    kr = (k - 1) * dilation // 2 if k > 1 else 0
    oH = (Hp - 2 * kr) // stride
    oW = (Wp - 2 * kr) // stride
    dev = x1.device
    ys = kr + torch.arange(oH, device=dev) * stride
    xs = kr + torch.arange(oW, device=dev) * stride
    ar_h, ar_w = torch.arange(Hp, device=dev), torch.arange(Wp, device=dev)
    outs = []
    for pi in range(patch):
        for pj in range(patch):
            dy = (pi - d) * dilation_patch
            dx = (pj - d) * dilation_patch
            shifted = torch.roll(x2, (-dy, -dx), dims=(-2, -1))
            vy = (ar_h + dy >= 0) & (ar_h + dy < Hp)
            vx = (ar_w + dx >= 0) & (ar_w + dx < Wp)
            prod = x1 * shifted * (vy[:, None] & vx[None, :])
            red = prod.sum(1)
            acc = torch.zeros((N, Hp, Wp), dtype=prod.dtype, device=dev)
            for u in range(k):
                for v in range(k):
                    du = (u - k // 2) * dilation
                    dv = (v - k // 2) * dilation
                    acc = acc + torch.roll(red, (-du, -dv), dims=(-2, -1))
            outs.append(acc[:, ys[:, None], xs[None, :]])
    return torch.stack(outs, 1).reshape(N, patch, patch, oH, oW)


def tin_shift(x, shift, device=None):
    """Temporal group shift: x (N, T, C, HW); shift (N, G) integers; channel
    group g reads frame ``t - shift[n, g]``, zero outside ``[0, T)``."""
    x = _tensor(x, device)
    shift = _tensor(shift, dtype=torch.int64, like=x)
    N, T, C, HW = x.shape
    G = shift.shape[1]
    dev = x.device
    src_t = (torch.arange(T, device=dev)[None, :, None]
             - shift.repeat_interleave(C // G, dim=1)[:, None, :])  # (N, T, C)
    valid = (src_t >= 0) & (src_t < T)
    n = torch.arange(N, device=dev)[:, None, None]
    c = torch.arange(C, device=dev)[None, None, :]
    out = x[n, src_t.clamp(0, T - 1), c]                             # (N, T, C, HW)
    return out * valid[..., None]


def psamask(input, psa_type: str, mask_h: int, mask_w: int, device=None):
    """Point-wise spatial attention mask: input (N, mask_h*mask_w, H, W) ->
    (N, H*W, H, W).  ``collect``: ``out[n, p, h, w] = in[n, c(p, h, w), h, w]``
    inside the window, 0 outside; ``distribute`` is its flattened
    transpose."""
    if psa_type not in ("collect", "distribute"):
        raise ValueError(f"psamask: unknown psa_type {psa_type!r}")
    input = _tensor(input, device)
    N, _, H, W = input.shape
    dev = input.device
    hh, hw = (mask_h - 1) // 2, (mask_w - 1) // 2
    p = torch.arange(H * W, device=dev)
    dh = (p // W)[:, None, None] - torch.arange(H, device=dev)[None, :, None] + hh
    dw = (p % W)[:, None, None] - torch.arange(W, device=dev)[None, None, :] + hw
    valid = (dh >= 0) & (dh < mask_h) & (dw >= 0) & (dw < mask_w)   # (HW, H, W)
    cidx = dh.clamp(0, mask_h - 1) * mask_w + dw.clamp(0, mask_w - 1)
    # one flat gather: channel cidx at pixel q = h * W + w
    lin = (cidx * (H * W) + torch.arange(H * W, device=dev).reshape(1, H, W)).reshape(-1)
    collect = input.reshape(N, -1)[:, lin].reshape(N, H * W, H, W) * valid
    if psa_type == "collect":
        return collect
    return collect.reshape(N, H * W, H * W).transpose(1, 2).reshape(N, H * W, H, W)


def border_align(input, boxes, pool_size: int = 10, device=None):
    """Pool the four borders of each box: input (N, 4C, H, W), channels
    grouped [top, left, bottom, right]; boxes (N, B, 4) xyxy -> (N, C, B, 4),
    the max of ``pool_size + 1`` bilinear samples walking each border
    (top from (x1, y1) along +x, left along +y, bottom from (x2, y2) along
    -x, right along -y)."""
    input = _tensor(input, device)
    boxes = _tensor(boxes, like=input)
    N, C4, H, W = input.shape
    C = C4 // 4
    steps = torch.arange(pool_size + 1, dtype=input.dtype, device=input.device)
    x1, y1, x2, y2 = (boxes[..., i:i + 1] for i in range(4))        # (N, B, 1)
    bw = exact_div(x2 - x1, pool_size)
    bh = exact_div(y2 - y1, pool_size)
    zeros = torch.zeros_like(bw)
    sx = torch.stack([x1 + steps * bw, x1 + steps * zeros,
                      x2 - steps * bw, x2 - steps * zeros], 1)      # (N, 4, B, S)
    sy = torch.stack([y1 + steps * zeros, y1 + steps * bh,
                      y2 - steps * zeros, y2 - steps * bh], 1)
    plane = torch.arange(N * 4, device=input.device).reshape(N, 4, 1, 1)
    vals = bilinear(feature_rows(input.reshape(N, 4, C, H, W)), H, W, plane, sy, sx)
    return vals.amax(3).permute(0, 3, 2, 1)                         # (N, C, B, 4)


def corner_pool(x, mode: str, device=None):
    """Directional cumulative max over H or W: ``top`` pools from the bottom
    up (``out[i] = max(x[i:])``), ``bottom`` from the top down, ``left`` from
    the right, ``right`` from the left."""
    axis, rev = {"top": (2, True), "bottom": (2, False),
                 "left": (3, True), "right": (3, False)}[mode]
    x = _tensor(x, device)
    if rev:
        x = torch.flip(x, (axis,))
    out = torch.cummax(x, axis)[0]
    return torch.flip(out, (axis,)) if rev else out
