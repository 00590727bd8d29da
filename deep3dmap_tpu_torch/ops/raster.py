"""Hard z-buffer grid-mesh depth rasterizer, soft splatting, straight-through.

Port of ``deep3dmap_tpu/ops/raster_pallas.py``.  The warped pixel grid
(B, H, W, 3) is a mesh of 2(H-1)(W-1) triangles; each pixel takes the least
perspective-correct depth of the triangles that cover it, or ``background``.

- ``raster_grid_depth_hard`` is the wrapper: a CUDA tensor launches the
  CUDA C++ kernel ``ops/csrc/raster_hard.cu`` (built by ``ops/_cuda.py`` at
  first use; a failed build or launch raises), a CPU tensor takes
  ``raster_grid_depth_hard_plain``.  ``launches`` counts kernel launches.
- ``raster_grid_depth_hard_plain`` is the same function in PyTorch ops:
  ``grid_mesh_triangles`` (the TPU kernel's triangle list, same order), then
  every pixel against every triangle, a chunk of triangles at a time with a
  running ``torch.minimum`` (the full (H*W, T) test would not fit: 5.3e8
  elements at 128²).  It is the CPU path and the kernel's reference.
- ``splat_depth_soft``: softmax-z-buffer bilinear splatting, the scatter as
  ``index_add_``.
- ``raster_depth_st``: the hard raster forward, the VJP of
  ``splat_depth_soft`` as its backward (plain ops: the TPU kernel has no
  backward kernel either).

Both versions project the points with ``project`` (elementwise float32,
``x * fx / z + cx`` in the order of the JAX package's ``proj @ K.T``) and
evaluate the inside test in the op order of ``raster_pallas.py:107-120``, so
on one device the kernel and the plain version give the same pixels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _cuda

EPS = 1e-7
PLAIN_CHUNK = 1024

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


def _zbuf_chunk(pxp, pyp, xs, ys, zs):
    """Least covering depth of each pixel (P, 1) over triangles (3, CH),
    +inf where none covers; raster_pallas.py:107-121, op for op."""
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
    zhit = torch.ones_like(inv_z) / torch.clamp(inv_z, min=EPS)
    zhit = torch.where(inside, zhit, torch.full_like(zhit, float("inf")))
    return zhit.amin(dim=1)


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


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _cuda.load("raster_hard").d3m_raster_grid_depth_hard
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def raster_grid_depth_hard_cuda(points3d: torch.Tensor, K: torch.Tensor,
                                background: float) -> torch.Tensor:
    """The CUDA kernel on CUDA tensors; raises on anything it does not take."""
    global launches
    if points3d.device.type != "cuda" or K.device != points3d.device:
        raise ValueError("raster_grid_depth_hard_cuda: points3d and K must be "
                         f"on one CUDA device, got {points3d.device} and "
                         f"{K.device}")
    B, H, W, _ = points3d.shape
    if B * H * W >= 2 ** 31:
        raise ValueError("raster_grid_depth_hard: too many pixels for int32")
    dev = points3d.device
    out = torch.empty((B, H, W), device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    px, py, z = (a.contiguous() for a in project(points3d.float(), K.float()))
    rowlo = torch.empty((B, H), device=dev, dtype=torch.float32)
    rowhi = torch.empty_like(rowlo)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        err = fn(px.data_ptr(), py.data_ptr(), z.data_ptr(), rowlo.data_ptr(),
                 rowhi.data_ptr(), out.data_ptr(), B, H, W, float(background),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"raster_grid_depth_hard: CUDA error {err} at launch")
    launches += 1
    return out


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
