"""Port parity: ``deep3dmap_tpu_torch/ops/raster.py`` against the JAX package's
``ops/raster_pallas.py`` (the Pallas kernel in interpret mode on the CPU) and
against the brute-force numpy rasterizer of ``tests/test_raster_pallas.py``.

Tolerances: depth values within 1e-4 abs and rel (the numpy reference's
projection is a BLAS product, JAX's an XLA dot; the port writes it out
elementwise, so a vertex may move by an ulp); the coverage mask (pixel !=
background) must be identical, no flipped pixel is allowed.  Splatting and
its gradient within 1e-5 (the scatter adds in another order).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deep3dmap_tpu.core.renderer.renderer_nr import NrRenderer as JNrRenderer
from deep3dmap_tpu.core.renderer.renderer_nr import \
    get_transform_matrices as jget_transform_matrices
from deep3dmap_tpu.ops import raster_pallas as J
from deep3dmap_tpu_torch.ops import _cuda
from deep3dmap_tpu_torch.ops import raster as T
from test_raster_pallas import BG, _make_points, numpy_raster_reference

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _two_sheet():
    H = W = 8
    K = np.array([[4.0, 0, (W - 1) / 2], [0, 4.0, (H - 1) / 2], [0, 0, 1]],
                 np.float32)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    g = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K).T
    pts = np.concatenate([g[None] * 1.0, g[None] * 1.5], axis=1)
    return pts.astype(np.float32), K


def _renderer16():
    r = JNrRenderer(dict(min_depth=0.9, max_depth=1.1, fov=10), image_size=16)
    rot, trans = jget_transform_matrices(
        jnp.asarray([[0.05, 0.1, 0.0, 0.01, 0.0, 0.0]]))
    pts = r.get_warped_3d_grid(jnp.full((1, 16, 16), 1.0), rot, trans)
    return np.asarray(pts), np.asarray(r.K)


def _ragged():
    pts, K = _make_points(seed=5, B=2, H=7, W=11, jitter=0.3)
    pts = np.asarray(pts).copy()
    pts[1] *= 1.1                     # the two items differ
    return pts, np.asarray(K)


def _behind_camera():
    pts, K = _make_points(seed=7, H=8, W=8, jitter=0.2)
    pts = np.asarray(pts).copy()
    pts[0, 2:4, 3:6, 2] = -0.5        # behind the camera
    pts[0, 5, 5, 2] = 0.0             # on the camera plane
    return pts, np.asarray(K)


def _jitter6():
    pts, K = _make_points(seed=3, H=6, W=6, jitter=0.2)
    return np.asarray(pts), np.asarray(K)


CASES = {"jitter_6x6": _jitter6, "two_sheet": _two_sheet,
         "renderer_16x16": _renderer16, "ragged_7x11_b2": _ragged,
         "behind_camera": _behind_camera}
# the numpy reference clamps z and tests every triangle, so it is the spec
# only where no vertex lies at or behind z = 1e-7
NUMPY_CASES = ("jitter_6x6", "two_sheet", "renderer_16x16", "ragged_7x11_b2")


def _assert_same_raster(want, got, bg=BG):
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    np.testing.assert_array_equal(want != bg, got != bg, err_msg="coverage")
    np.testing.assert_allclose(got, want, **TOL)


def test_grid_mesh_triangles_match_jax(rng):
    pix = rng.uniform(-2, 9, (2, 5, 7, 2)).astype(np.float32)
    z = rng.uniform(0.5, 1.5, (2, 5, 7)).astype(np.float32)
    want = J.grid_mesh_triangles(jnp.asarray(pix), jnp.asarray(z))
    got = T.grid_mesh_triangles(_t(pix), _t(z))
    T_ = 2 * 4 * 6
    for w, g in zip(want, got):
        # JAX pads its list to the TPU kernel's 128-triangle chunk; the
        # port's list stops at T
        assert tuple(g.shape) == (2, 3, T_) and w.shape == (2, 3, 128)
        np.testing.assert_array_equal(np.asarray(w)[..., :T_], g.numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_raster_matches_jax(case):
    pts, K = CASES[case]()
    want = J.raster_grid_depth_hard(jnp.asarray(pts), jnp.asarray(K),
                                    background=BG, interpret=True)
    got = T.raster_grid_depth_hard_plain(_t(pts), _t(K), BG)
    assert got.dtype == torch.float32 and tuple(got.shape) == pts.shape[:3]
    _assert_same_raster(want, got.numpy())
    if case in NUMPY_CASES:
        _assert_same_raster(numpy_raster_reference(pts, K), got.numpy())


def test_behind_camera_case_has_holes_and_hits():
    """The z <= 0 case exercises both branches: some pixels covered, and the
    triangles touching the moved vertices dropped."""
    pts, K = _behind_camera()
    out = T.raster_grid_depth_hard_plain(_t(pts), _t(K), BG).numpy()
    assert (out != BG).sum() > 10 and (out == BG).sum() > 0


def test_two_sheet_takes_the_near_surface():
    pts, K = _two_sheet()
    out = T.raster_grid_depth_hard_plain(_t(pts), _t(K), BG).numpy()
    assert out[0, 4, 4] == pytest.approx(1.0, abs=1e-3)


@pytest.mark.parametrize("chunk", [128, 300])
def test_chunked_plain_equals_unchunked(chunk):
    pts, K = _renderer16()
    a = T.raster_grid_depth_hard_plain(_t(pts), _t(K), BG, chunk=chunk)
    b = T.raster_grid_depth_hard_plain(_t(pts), _t(K), BG, chunk=None)
    assert torch.equal(a, b)


def test_splat_depth_soft_matches_jax():
    pts, K = _ragged()
    want = J.splat_depth_soft(jnp.asarray(pts), jnp.asarray(K), 0.9, 1.1, 20.0)
    got = T.splat_depth_soft(_t(pts), _t(K), 0.9, 1.1, 20.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_raster_depth_st_gradient_matches_jax():
    pts, K = _make_points(seed=1, H=6, W=6, jitter=0.1)
    pts, K = np.asarray(pts), np.asarray(K)

    def jloss(p):
        return jnp.sum(J.raster_depth_st(p, jnp.asarray(K), 0.9, BG, 20.0, True) ** 2)

    want_val = float(jloss(jnp.asarray(pts)))
    want = np.asarray(jax.grad(jloss)(jnp.asarray(pts)))
    p = _t(pts).requires_grad_(True)
    val = torch.sum(T.raster_depth_st(p, _t(K), 0.9, BG, 20.0) ** 2)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), want_val, rtol=1e-6)
    assert np.abs(want).sum() > 0
    np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-5, rtol=0)


def test_wrapper_on_cpu_takes_plain_and_counts_no_launch():
    pts, K = _jitter6()
    before = T.launches
    got = T.raster_grid_depth_hard(_t(pts), _t(K), BG)
    assert T.launches == before
    assert torch.equal(got, T.raster_grid_depth_hard_plain(_t(pts), _t(K), BG))
    with pytest.raises(ValueError, match="CUDA"):
        T.raster_grid_depth_hard_cuda(_t(pts), _t(K), BG)


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(_cuda.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.find_nvcc()


def test_import_needs_no_nvcc(tmp_path):
    """Importing the raster module runs no compiler: with a PATH that holds
    no nvcc it imports, and no library appears in the build directory."""
    before = set(os.listdir(_cuda.BUILD_DIR)) if os.path.isdir(_cuda.BUILD_DIR) else set()
    env = dict(os.environ, PATH=str(tmp_path))
    code = ("import deep3dmap_tpu_torch.ops.raster as r; "
            "import deep3dmap_tpu_torch.core.renderer.renderer_nr; "
            "print(r.launches)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0"
    after = set(os.listdir(_cuda.BUILD_DIR)) if os.path.isdir(_cuda.BUILD_DIR) else set()
    assert after == before


# ---- the CUDA kernel's bounding-box rule (ops/raster.py::cull_box) -------
# The kernel tests only the pixels of each triangle's box, so every pixel
# that the plain inside test accepts must lie in that box.

def _tris(pts, K):
    px, py, z = T.project(_t(pts), _t(K))
    return T.grid_mesh_triangles(torch.stack([px, py], -1), z)


def _box_grid_behind_camera():
    pts, K = _make_points(seed=11, H=14, W=16, jitter=0.2)
    pts = np.asarray(pts).copy()
    pts[0, 2:5, 3:7, 2] = -0.5        # behind the camera
    pts[0, 6, 6, 2] = 0.0             # on the camera plane
    pts[0, 8] = pts[0, 7]             # a collapsed row: zero-area quads
    pts[0, 10:12, 2:5] = pts[0, 10, 2]
    pts[0, 12, 1:12] = pts[0, 12, 1] + np.linspace(0, 1, 11)[:, None] * \
        (pts[0, 12, 11] - pts[0, 12, 1])   # collinear vertices
    return (*_tris(pts, np.asarray(K)), 14, 16)


def _box_slivers():
    """Triangle soup of slivers whose area sits just above the kernel's
    sliver cut (|denom| = k 2^-16 E², k in [1, 64]) and of needles below
    it, along random directions through the image."""
    rng = np.random.RandomState(3)
    n, H, W = 600, 24, 24
    v0 = rng.uniform(-4, W + 4, (n, 2))
    ang = rng.uniform(0, 2 * np.pi, n)
    d = np.stack([np.cos(ang), np.sin(ang)], -1)
    length = rng.uniform(1, 30, n)
    s1 = rng.uniform(0.1, 0.9, n) * length
    k = np.where(np.arange(n) % 3 == 0, rng.uniform(0.01, 1, n),
                 rng.uniform(1, 64, n))
    h = k * 2.0 ** -16 * length             # denom ~ length * h
    perp = np.stack([-d[:, 1], d[:, 0]], -1)
    v1 = v0 + d * length[:, None]
    v2 = v0 + d * s1[:, None] + perp * h[:, None]
    xs = np.stack([v0[:, 0], v1[:, 0], v2[:, 0]])[None]
    ys = np.stack([v0[:, 1], v1[:, 1], v2[:, 1]])[None]
    zs = rng.uniform(0.5, 2, (1, 3, n))
    return _t(xs), _t(ys), _t(zs), H, W


def _box_near_clip_edge():
    """A grid whose border vertices sit within a pixel of the image edges."""
    pts, K = _make_points(seed=5, H=12, W=12, jitter=0.1)
    pts = np.asarray(pts).copy()
    K = np.asarray(K).copy()
    K[0, 0] = K[1, 1] = 8.0 * 13 / 11   # vertex columns span ~[-1, 12]
    return (*_tris(pts, K), 12, 12)


def _box_far_vertices():
    """Vertices at ~1e5-1e9 pixels: z just above EPS on a grid, triangles
    with one vertex on the image and two far away, and thin wedges from an
    apex on the image (their apex rounds coarsely: the margin case)."""
    pts, K = _make_points(seed=9, H=10, W=10, jitter=0.2)
    pts = np.asarray(pts).copy()
    pts[0, 3:6, 2:7, 2] = np.float32(1.5e-7)   # x, y ~ 1e7 pixels
    xs, ys, zs = _tris(pts, np.asarray(K))
    rng = np.random.RandomState(4)
    n = 300
    near = rng.uniform(-1, 11, (n, 2))
    far = rng.uniform(-1, 1, (n, 2, 2)) * 10.0 ** rng.uniform(5, 8.5, (n, 1, 1))
    X = 10.0 ** rng.uniform(6, 9, n) * rng.choice([-1, 1], n)
    slope = 10.0 ** rng.uniform(-3, 0, n)
    w1 = np.stack([near[:, 0] + X, near[:, 1] + X * slope * rng.uniform(-1, 1, n)], -1)
    w2 = np.stack([near[:, 0] + X * rng.uniform(0.5, 1.5, n),
                   near[:, 1] + X * slope * rng.uniform(-1, 1, n)], -1)
    v0 = np.concatenate([near, near])
    v1 = np.concatenate([far[:, 0], w1])
    v2 = np.concatenate([far[:, 1], w2])
    swap = rng.rand(2 * n) < 0.5        # wedges along y as well as x
    for v in (v0, v1, v2):
        v[swap] = v[swap][:, ::-1]
    sx = np.stack([v0[:, 0], v1[:, 0], v2[:, 0]])[None]
    sy = np.stack([v0[:, 1], v1[:, 1], v2[:, 1]])[None]
    sz = rng.uniform(0.5, 2, (1, 3, 2 * n))
    return (torch.cat([xs, _t(sx)], -1), torch.cat([ys, _t(sy)], -1),
            torch.cat([zs, _t(sz)], -1), 10, 10)


def _box_nan_vertices():
    pts, K = _make_points(seed=6, H=10, W=12, jitter=0.2)
    pts = np.asarray(pts).copy()
    pts[0, 4, 5, 0] = np.nan
    pts[0, 6, 2, 2] = np.nan
    pts[0, 2, 9, 1] = np.inf
    return (*_tris(pts, np.asarray(K)), 10, 12)


def _box_random_warp(seed):
    """Seeded rigid views of a bumpy surface, as the renderer warps it."""
    def make():
        rng = np.random.RandomState(seed)
        r = JNrRenderer(dict(min_depth=0.9, max_depth=1.1, fov=10), image_size=20)
        view = rng.uniform(-1, 1, (2, 6)) * np.array([np.pi / 3] * 3 + [0.1] * 3)
        rot, trans = jget_transform_matrices(jnp.asarray(view, jnp.float32))
        depth = 1.0 + 0.1 * rng.rand(2, 20, 20)
        pts = r.get_warped_3d_grid(jnp.asarray(depth, jnp.float32), rot, trans)
        return (*_tris(np.asarray(pts), np.asarray(r.K)), 20, 20)
    return make


BOX_CASES = {"behind_camera_degenerate": _box_grid_behind_camera,
             "slivers": _box_slivers, "near_clip_edge": _box_near_clip_edge,
             "far_vertices_1e7": _box_far_vertices,
             "nan_vertices": _box_nan_vertices,
             "random_warp_0": _box_random_warp(0),
             "random_warp_1": _box_random_warp(1),
             "random_warp_2": _box_random_warp(2)}


@pytest.mark.parametrize("case", sorted(BOX_CASES))
def test_cull_box_keeps_every_hit(case):
    xs, ys, zs, H, W = BOX_CASES[case]()
    x_lo, nx, y_lo, ny = T.cull_box(xs, ys, zs, H, W)
    lin = torch.arange(H * W)
    px, py = lin % W, lin // W
    pxp, pyp = px.float()[:, None], py.float()[:, None]
    hits = 0
    for b in range(xs.shape[0]):
        inside, _ = T._hits(pxp, pyp, xs[b], ys[b], zs[b])
        inbox = ((px[:, None] >= x_lo[b]) & (px[:, None] < x_lo[b] + nx[b]) &
                 (py[:, None] >= y_lo[b]) & (py[:, None] < y_lo[b] + ny[b]))
        lost = inside & ~inbox
        assert not lost.any(), \
            f"{int(lost.sum())} hits outside their box, triangles " \
            f"{torch.nonzero(lost.any(0)).flatten()[:8].tolist()}"
        hits += int(inside.sum())
        assert (nx[b] >= 0).all() and (x_lo[b] + nx[b] <= W).all()
        assert (ny[b] >= 0).all() and (y_lo[b] + ny[b] <= H).all()
    assert hits > 0


def test_cull_box_sends_slivers_and_large_boxes_to_the_overflow_path():
    xs, ys, zs, H, W = _box_slivers()
    x_lo, nx, y_lo, ny = T.cull_box(xs, ys, zs, H, W)
    x0, x1, x2 = xs[0]
    y0, y1, y2 = ys[0]
    denom = ((y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)).abs()
    ext = torch.maximum(xs[0].amax(0) - xs[0].amin(0), ys[0].amax(0) - ys[0].amin(0))
    thin = (denom > 1e-9) & (ext * ext >= 2.0 ** 16 * denom) & (nx[0] * ny[0] > 0)
    assert thin.any() and (nx[0] * ny[0] > T.FAST_PIXELS)[thin].all()
    # a grid stretched over the image: every triangle's box is large
    pts, K = _make_points(seed=2, H=4, W=4, jitter=0.0)
    K = np.asarray(K).copy()
    K[0, 0] = K[1, 1] = 8.0 * 30      # vertices 30 pixels apart,
    K[0, 2] = K[1, 2] = 47.5          # centred on a 96² image
    xs, ys, zs = _tris(np.asarray(pts), K)
    x_lo, nx, y_lo, ny = T.cull_box(xs, ys, zs, 96, 96)
    assert (nx * ny > T.FAST_PIXELS).all()


@pytest.mark.parametrize("case", ["behind_camera_degenerate", "near_clip_edge",
                                  "nan_vertices", "random_warp_0"])
def test_box_rule_reproduces_plain_raster(case):
    """The kernel's algorithm (each triangle tests the pixels of its box and
    folds hits with a min) in plain ops equals the plain raster bit for bit."""
    xs, ys, zs, H, W = BOX_CASES[case]()
    x_lo, nx, y_lo, ny = T.cull_box(xs, ys, zs, H, W)
    for b in range(xs.shape[0]):
        zbuf = torch.full((H * W,), float("inf"))
        for t in range(xs.shape[-1]):
            x0, y0 = int(x_lo[b, t]), int(y_lo[b, t])
            if nx[b, t] * ny[b, t] == 0:
                continue
            yy, xx = torch.meshgrid(torch.arange(y0, y0 + int(ny[b, t])),
                                    torch.arange(x0, x0 + int(nx[b, t])),
                                    indexing="ij")
            sl = slice(t, t + 1)
            zb = T._zbuf_chunk(xx.reshape(-1, 1).float(), yy.reshape(-1, 1).float(),
                               xs[b, :, sl], ys[b, :, sl], zs[b, :, sl])
            idx = (yy * W + xx).reshape(-1)
            zbuf[idx] = torch.minimum(zbuf[idx], zb)
        lin = torch.arange(H * W)
        want = T._zbuf_chunk((lin % W).float()[:, None], (lin // W).float()[:, None],
                             xs[b], ys[b], zs[b])
        assert torch.equal(zbuf, want)
