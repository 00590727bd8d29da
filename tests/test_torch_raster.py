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
