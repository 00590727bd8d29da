"""The hard raster CUDA kernel against its plain version, on the card.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only the port's requirements:

    python -m pytest --noconftest -m cuda tests/test_torch_raster_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets JAX up.)  The first test builds
``ops/csrc/raster_hard.cu`` with ``nvcc``.  Without a CUDA device every test
here skips.  The kernel and the plain version evaluate the inside test in
the same float32 op order, so coverage must be identical and the depths
equal bit for bit; the overflow path's triangle count must match the plain
box rule (``raster.overflow_triangles_plain``).
"""
import numpy as np
import pytest
import torch

from deep3dmap_tpu_torch.core.renderer.renderer_nr import (
    NrRenderer, get_transform_matrices)
from deep3dmap_tpu_torch.ops import raster
from deep3dmap_tpu_torch.utils.tracing import counter

BG = 2.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the raster kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _grid_points(rng, B, H, W, jitter, f=8.0):
    K = np.array([[f, 0, (W - 1) / 2], [0, f, (H - 1) / 2], [0, 0, 1]], np.float32)
    z = 1.0 + jitter * rng.rand(B, H, W).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    g = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K).T
    return (g[None] * z[..., None]).astype(np.float32), K


def _compare(pts, K, dev, bg=BG):
    p = torch.from_numpy(np.ascontiguousarray(pts)).to(dev)
    k = torch.from_numpy(K).to(dev)
    before = counter("raster.launches")
    got, n_big = raster.raster_grid_depth_hard_cuda(p, k, bg, overflow=True)
    want = raster.raster_grid_depth_hard_plain(p, k, bg)
    torch.cuda.synchronize()
    assert counter("raster.launches") == before + 1
    assert torch.equal(got != bg, want != bg), \
        f"{int((got != want).sum())} pixels differ"
    assert (got - want).abs().max().item() <= 1e-6
    assert torch.equal(got, want)
    assert int(n_big) == int(raster.overflow_triangles_plain(p, k))
    return got, int(n_big)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W", [(1, 6, 6), (2, 37, 53), (1, 128, 128)])
def test_kernel_matches_plain_on_grids(cuda_device, B, H, W):
    rng = np.random.RandomState(H * W)
    pts, K = _grid_points(rng, B, H, W, jitter=0.3)
    out, _ = _compare(pts, K, cuda_device)
    assert (out != BG).any()


@pytest.mark.cuda
def test_kernel_matches_plain_behind_camera_and_degenerate(cuda_device):
    rng = np.random.RandomState(1)
    pts, K = _grid_points(rng, 1, 20, 24, jitter=0.2)
    pts[0, 3:6, 4:9, 2] = -0.5          # behind the camera
    pts[0, 8, 10, 2] = 0.0              # on the camera plane
    pts[0, 12] = pts[0, 11]             # a collapsed row: zero-area quads
    pts[0, 15:17, 5:8] = pts[0, 15, 5]  # a collapsed patch
    _compare(pts, K, cuda_device)


@pytest.mark.cuda
def test_kernel_matches_plain_on_renderer_views(cuda_device):
    r = NrRenderer(dict(min_depth=0.9, max_depth=1.1, raster_mode="hard"), 64,
                   device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    depth = 1.0 + 0.1 * torch.rand((3, 64, 64), generator=g, device=cuda_device)
    view = (torch.rand((3, 6), generator=g, device=cuda_device) - 0.5) * 0.6
    R, t = get_transform_matrices(view)
    pts = r.get_warped_3d_grid(depth, R, t)
    _compare(pts.cpu().numpy(), r.K.cpu().numpy(), cuda_device, bg=1.1)


@pytest.mark.cuda
def test_all_background_and_bad_inputs(cuda_device):
    rng = np.random.RandomState(2)
    pts, K = _grid_points(rng, 1, 16, 16, jitter=0.1)
    pts[..., 0] += 100.0                # the whole mesh off screen
    out, _ = _compare(pts, K, cuda_device)
    assert (out == BG).all()
    with pytest.raises(ValueError):
        raster.raster_grid_depth_hard_cuda(torch.from_numpy(pts),
                                           torch.from_numpy(K), BG)


def _zoomed():
    """A 64² grid seen 20x magnified: the on-screen triangles are ~20 pixels
    wide, so they take the overflow path."""
    pts, K = _grid_points(np.random.RandomState(3), 1, 64, 64, jitter=0.05)
    K = K.copy()
    K[0, 0] = K[1, 1] = 8.0 * 20
    return pts, K


def _near_camera():
    """A jittered grid with two patches of vertices pulled near the camera
    (z > EPS): their triangles reach across the image, the rest stay small."""
    pts, K = _grid_points(np.random.RandomState(4), 1, 48, 48, jitter=0.2)
    pts[0, 10:13, 10:13, 2] = 0.02
    pts[0, 30:32, 25:28, 2] = 0.05
    return pts, K


def _folded():
    """A 64² mesh folded into a few pixels: many triangles cover each pixel
    centre there, and their atomics contend."""
    H = W = 64
    f, cx = 8.0, (W - 1) / 2
    rr, cc = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    u = 30.0 + 2.0 * np.sin(0.37 * cc) + 0.01 * rr
    v = 30.0 + 2.0 * np.sin(0.29 * rr) + 0.01 * cc
    z = 1.0 + 0.2 * np.random.RandomState(5).rand(H, W)
    pts = np.stack([(u - cx) / f * z, (v - cx) / f * z, z], -1)[None]
    K = np.array([[f, 0, cx], [0, f, cx], [0, 0, 1]], np.float32)
    return pts.astype(np.float32), K


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zoomed", "near_camera", "folded"])
def test_kernel_matches_plain_on_overflow_and_contention(cuda_device, case):
    pts, K = dict(zoomed=_zoomed, near_camera=_near_camera, folded=_folded)[case]()
    out, n_big = _compare(pts, K, cuda_device)
    n_tri = 2 * (pts.shape[1] - 1) * (pts.shape[2] - 1)
    assert (out != BG).any()
    if case == "zoomed":
        assert n_big > 0
    if case == "near_camera":
        assert 0 < n_big < n_tri
