"""Hard z-buffer grid-mesh depth rasterizer, soft splatting, straight-through.

Port of ``deep3dmap_tpu/ops/raster_pallas.py``.  The warped pixel grid
(B, H, W, 3) is a mesh of 2(H-1)(W-1) triangles; each pixel takes the least
perspective-correct depth of the triangles that cover it, or ``background``.

- ``raster_grid_depth_hard`` is the wrapper: a CUDA tensor launches the
  CUDA C++ kernel ``ops/csrc/raster_hard.cu`` (built by ``ops/_cuda.py`` at
  first use; a failed build or launch raises), a CPU tensor takes
  ``raster_grid_depth_hard_plain``.  The kernel projects the points itself,
  four threads per triangle, so a call is one ctypes call and no PyTorch op;
  ``launches`` counts those calls.
- ``raster_grid_depth_hard_plain`` is the same function in PyTorch ops:
  ``project``, ``grid_mesh_triangles`` (the TPU kernel's triangle list, same
  order), then every pixel against every triangle, a chunk of triangles at
  a time with a running ``torch.minimum`` (the full (H*W, T) test would not
  fit: 5.3e8 elements at 128²).  It is the CPU path and the kernel's
  reference.
- ``cull_box`` states the kernel's bounding-box rule (margin, clipping, the
  overflow threshold ``FAST_PIXELS``); the CPU tests hold it against the
  plain inside test.
- ``splat_depth_soft``: softmax-z-buffer bilinear splatting, the scatter as
  ``index_add_``.
- ``raster_depth_st``: the hard raster forward, the VJP of
  ``splat_depth_soft`` as its backward (plain ops: the TPU kernel has no
  backward kernel either).

The kernel projects in ``project``'s op order (elementwise float32,
``x * fx / z + cx`` in the order of the JAX package's ``proj @ K.T``) and
both versions evaluate the inside test in the op order of
``raster_pallas.py:107-120``, so on one device the kernel and the plain
version give the same pixels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _cuda

EPS = 1e-7
PLAIN_CHUNK = 1024
# ops/csrc/raster_hard.cu: boxes of more pixels take the overflow kernel
FAST_PIXELS = 64

launches = 0     # kernel launches since the last reset


def project(points3d: torch.Tensor, K: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Camera points (B, H, W, 3) -> pixel x, pixel y and depth z, each
    (B, H, W); z is clamped to >= 1e-7 as in the JAX package.  The 3x3
    product is written out elementwise (no BLAS, no TF32), so it rounds the
    same on the CPU and on the card."""
    z = torch.clamp(points3d[..., 2], min=EPS)
    proj = points3d / z[..., None]
    p0, p1, p2 = proj[..., 0], proj[..., 1], proj[..., 2]
    px = p0 * K[0, 0] + p1 * K[0, 1] + p2 * K[0, 2]
    py = p0 * K[1, 0] + p1 * K[1, 1] + p2 * K[1, 2]
    return px, py, z


def grid_mesh_triangles(pix: torch.Tensor, z: torch.Tensor):
    """The pixel-grid quad mesh's triangles from projected vertices.

    pix (B, H, W, 2) pixel coords, z (B, H, W) camera depth -> xs, ys, zs
    each (B, 3, T) with T = 2(H-1)(W-1); unlike the JAX package's list it is
    not padded to the TPU kernel's 128-triangle chunk.  Triangle A of each
    quad is (v00, v01, v10), triangle B (v11, v10, v01); all A triangles come
    first.
    """
    B, H, W = z.shape
    px, py = pix[..., 0], pix[..., 1]

    def corners(a):
        return a[:, :-1, :-1], a[:, :-1, 1:], a[:, 1:, :-1], a[:, 1:, 1:]

    def tris(a):
        a00, a01, a10, a11 = corners(a)
        ta = torch.stack([a00, a01, a10], dim=1).reshape(B, 3, -1)
        tb = torch.stack([a11, a10, a01], dim=1).reshape(B, 3, -1)
        return torch.cat([ta, tb], dim=-1)

    return tris(px), tris(py), tris(z)


def _hits(pxp, pyp, xs, ys, zs):
    """Inside test and depth of each pixel (P, 1) against triangles (3, CH):
    (inside (P, CH), depth (P, CH)); raster_pallas.py:107-120, op for op."""
    x0, x1, x2 = xs[0:1], xs[1:2], xs[2:3]
    y0, y1, y2 = ys[0:1], ys[1:2], ys[2:3]
    z0, z1, z2 = zs[0:1], zs[1:2], zs[2:3]
    denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
    ok = (torch.abs(denom) > 1e-9) & (z0 > EPS) & (z1 > EPS) & (z2 > EPS)
    one = torch.ones_like(denom)
    inv_d = one / torch.where(ok, denom, one)   # a true division, as in CUDA
    dx2 = pxp - x2
    dy2 = pyp - y2
    l0 = ((y1 - y2) * dx2 + (x2 - x1) * dy2) * inv_d
    l1 = ((y2 - y0) * dx2 + (x0 - x2) * dy2) * inv_d
    l2 = 1.0 - l0 - l1
    inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & ok
    inv_z = l0 / z0 + l1 / z1 + l2 / z2
    return inside, torch.ones_like(inv_z) / torch.clamp(inv_z, min=EPS)


def _zbuf_chunk(pxp, pyp, xs, ys, zs):
    """Least covering depth of each pixel (P, 1) over triangles (3, CH),
    +inf where none covers."""
    inside, zhit = _hits(pxp, pyp, xs, ys, zs)
    zhit = torch.where(inside, zhit, torch.full_like(zhit, float("inf")))
    return zhit.amin(dim=1)


def cull_box(xs: torch.Tensor, ys: torch.Tensor, zs: torch.Tensor, H: int,
             W: int):
    """The kernel's pixel box of each triangle, float32 op for op as
    ``raster_hard.cu::load_tri`` takes it.  xs, ys, zs (..., 3, T) ->
    (x_lo, nx, y_lo, ny), int64 (..., T): columns x_lo .. x_lo + nx - 1 and
    rows y_lo .. y_lo + ny - 1 (nx * ny = 0 for a dropped triangle).

    A valid triangle's box is [floor(min - u) - 1, ceil(max + u) + 1] on
    each axis, with u = 2^-16 m E² / |denom| for coordinates up to m (at
    least W, H) and extent E: how far the rounding of the inside test can
    reach past the triangle.  It is clipped to the image in float before any
    cast, and is the whole image where the denominator is not finite.  A box
    of more than ``FAST_PIXELS`` pixels takes the kernel's overflow path."""
    x0, x1, x2 = xs.unbind(-2)
    y0, y1, y2 = ys.unbind(-2)
    z0, z1, z2 = zs.unbind(-2)
    denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
    ok = (denom.abs() > 1e-9) & (z0 > EPS) & (z1 > EPS) & (z2 > EPS)
    whole = ok & ~torch.isfinite(denom)
    xmin = torch.minimum(torch.minimum(x0, x1), x2)
    xmax = torch.maximum(torch.maximum(x0, x1), x2)
    ymin = torch.minimum(torch.minimum(y0, y1), y2)
    ymax = torch.maximum(torch.maximum(y0, y1), y2)
    ext = torch.maximum(xmax - xmin, ymax - ymin)
    m = torch.maximum(torch.maximum(xmin.abs(), xmax.abs()),
                      torch.maximum(ymin.abs(), ymax.abs()))
    m = torch.clamp(m, min=float(max(W, H)))
    u = (m * 2.0 ** -16) * (ext * (ext / denom.abs()))

    def axis(cmin, cmax, n):
        lo = torch.clamp(torch.floor(cmin - u) - 1.0, min=0.0)
        hi = torch.clamp(torch.ceil(cmax + u) + 1.0, max=float(n - 1))
        on = (hi >= lo) & ok
        lo = torch.where(on & ~whole, lo, torch.zeros_like(lo))
        cnt = torch.where(on, hi - lo + 1.0, torch.zeros_like(lo))
        cnt = torch.where(whole, torch.full_like(cnt, float(n)), cnt)
        return lo.long(), cnt.long()
    x_lo, nx = axis(xmin, xmax, W)
    y_lo, ny = axis(ymin, ymax, H)
    return x_lo, nx, y_lo, ny


def raster_grid_depth_hard_plain(points3d: torch.Tensor, K: torch.Tensor,
                                 background: float,
                                 chunk: Optional[int] = PLAIN_CHUNK
                                 ) -> torch.Tensor:
    """``raster_grid_depth_hard`` in PyTorch ops, on any device: every pixel
    against every triangle, ``chunk`` triangles at a time (all at once for
    ``None``), folding a running ``torch.minimum``.  No culling."""
    B, H, W, _ = points3d.shape
    px, py, z = project(points3d.float(), K.float())
    xs, ys, zs = grid_mesh_triangles(torch.stack([px, py], -1), z)
    HW, T = H * W, xs.shape[-1]
    lin = torch.arange(HW, device=points3d.device)
    pxp = (lin % W).float()[:, None]
    pyp = (lin // W).float()[:, None]
    step = T if chunk is None else chunk
    out = []
    for b in range(B):
        zbuf = torch.full((HW,), float("inf"), device=points3d.device)
        for t0 in range(0, T, step):
            sl = slice(t0, t0 + step)
            zbuf = torch.minimum(zbuf, _zbuf_chunk(pxp, pyp, xs[b, :, sl],
                                                   ys[b, :, sl], zs[b, :, sl]))
        out.append(torch.where(torch.isfinite(zbuf), zbuf,
                               torch.full_like(zbuf, float(background))))
    return torch.stack(out).reshape(B, H, W)


def overflow_triangles_plain(points3d: torch.Tensor, K: torch.Tensor
                             ) -> torch.Tensor:
    """How many triangles take the kernel's overflow path (``cull_box``'s
    box holds more than ``FAST_PIXELS`` pixels): a 0-d int64 tensor."""
    B, H, W, _ = points3d.shape
    px, py, z = project(points3d.float(), K.float())
    xs, ys, zs = grid_mesh_triangles(torch.stack([px, py], -1), z)
    _, nx, _, ny = cull_box(xs, ys, zs, H, W)
    return (nx * ny > FAST_PIXELS).sum()


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _cuda.load("raster_hard").d3m_raster_grid_depth_hard
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def raster_grid_depth_hard_cuda(points3d: torch.Tensor, K: torch.Tensor,
                                background: float, overflow: bool = False):
    """The CUDA kernel on CUDA tensors; raises on anything it does not take.
    With ``overflow`` it returns (depth, n) where ``n`` is a one-element
    int32 device tensor: the triangles that took the overflow path."""
    global launches
    if points3d.device.type != "cuda" or K.device != points3d.device:
        raise ValueError("raster_grid_depth_hard_cuda: points3d and K must be "
                         f"on one CUDA device, got {points3d.device} and "
                         f"{K.device}")
    if points3d.dim() != 4 or points3d.shape[-1] != 3 or K.shape != (3, 3):
        raise ValueError("raster_grid_depth_hard_cuda: points3d must be "
                         f"(B, H, W, 3) and K (3, 3), got {tuple(points3d.shape)}"
                         f" and {tuple(K.shape)}")
    B, H, W, _ = points3d.shape
    if 8 * B * H * W >= 2 ** 31:   # 4 threads per triangle, int32 ids
        raise ValueError("raster_grid_depth_hard: too many triangles for int32")
    dev = points3d.device
    out = torch.empty((B, H, W), device=dev, dtype=torch.float32)
    n_tri = 2 * B * max(H - 1, 0) * max(W - 1, 0)
    # the overflow count, then the overflow list
    scratch = torch.empty((n_tri + 1,), device=dev, dtype=torch.int32)
    if out.numel() == 0:
        return (out, scratch[:1].zero_()) if overflow else out
    pts = points3d.float().contiguous()
    k = K.float().contiguous()
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        err = fn(pts.data_ptr(), k.data_ptr(), out.data_ptr(),
                 scratch.data_ptr() + 4, scratch.data_ptr(), B, H, W,
                 float(background), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"raster_grid_depth_hard: CUDA error {err} at launch")
    launches += 1
    return (out, scratch[:1]) if overflow else out


def raster_grid_depth_hard(points3d: torch.Tensor, K: torch.Tensor,
                           background: float) -> torch.Tensor:
    """Rasterize warped grid points (B, H, W, 3) seen through intrinsics K
    (3, 3) into a hard-z-buffer depth map (B, H, W), float32; uncovered
    pixels get ``background``.  CUDA tensors launch the kernel, CPU tensors
    take the plain version."""
    if points3d.device.type == "cpu" and K.device.type == "cpu":
        return raster_grid_depth_hard_plain(points3d, K, background)
    return raster_grid_depth_hard_cuda(points3d, K, background)


def splat_depth_soft(points3d: torch.Tensor, K: torch.Tensor, min_depth: float,
                     max_depth: float, beta: float = 20.0) -> torch.Tensor:
    """Softmax-z-buffer bilinear point splatting (differentiable everywhere);
    the soft counterpart used for straight-through gradients."""
    b, h, w, _ = points3d.shape
    px, py, z = project(points3d, K)
    px, py, zf = px.reshape(b, -1), py.reshape(b, -1), z.reshape(b, -1)

    z_norm = (zf - min_depth) / max(max_depth - min_depth, 1e-6)
    z_norm = z_norm - z_norm.amin(dim=1, keepdim=True).detach()
    wz = torch.exp(-beta * z_norm)

    x0 = torch.floor(px)
    y0 = torch.floor(py)
    base = (torch.arange(b, device=points3d.device) * (h * w))[:, None]
    num = torch.zeros(b * h * w, device=points3d.device, dtype=zf.dtype)
    den = torch.zeros(b * h * w, device=points3d.device, dtype=zf.dtype)
    wx = px - x0
    wy = py - y0
    for dx, dy, wgt in ((0, 0, (1 - wx) * (1 - wy)), (1, 0, wx * (1 - wy)),
                        (0, 1, (1 - wx) * wy), (1, 1, wx * wy)):
        xi, yi = x0 + dx, y0 + dy
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        # NaN coordinates are out of bounds: any in-range index serves them
        idx = (torch.nan_to_num(torch.clamp(yi, 0, h - 1)).long() * w
               + torch.nan_to_num(torch.clamp(xi, 0, w - 1)).long() + base)
        wgt = wgt * inb
        num = num.index_add_(0, idx.reshape(-1), (wgt * wz * zf).reshape(-1))
        den = den.index_add_(0, idx.reshape(-1), (wgt * wz).reshape(-1))

    depth = num / torch.clamp(den, min=EPS)
    depth = torch.where(den > 1e-4, depth, torch.full_like(depth, max_depth))
    return depth.reshape(b, h, w)


class _RasterDepthST(torch.autograd.Function):
    """Hard-z-buffer forward, soft-splat backward (straight-through)."""

    @staticmethod
    def forward(ctx, points3d, K, min_depth, max_depth, beta):
        ctx.save_for_backward(points3d, K)
        ctx.splat = (min_depth, max_depth, beta)
        return raster_grid_depth_hard(points3d, K, background=max_depth)

    @staticmethod
    def backward(ctx, g):
        points3d, K = ctx.saved_tensors
        with torch.enable_grad():
            p = points3d.detach().requires_grad_(True)
            soft = splat_depth_soft(p, K.detach(), *ctx.splat)
            (dp,) = torch.autograd.grad(soft, p, g)
        dK = torch.zeros_like(K) if ctx.needs_input_grad[1] else None
        return dp, dK, None, None, None


def raster_depth_st(points3d: torch.Tensor, K: torch.Tensor, min_depth: float,
                    max_depth: float, beta: float) -> torch.Tensor:
    """Hard-z-buffer depth forward (``background = max_depth``), gradients
    w.r.t. the points from ``splat_depth_soft``'s VJP."""
    return _RasterDepthST.apply(points3d, K, min_depth, max_depth, beta)
