"""Port parity: ``deep3dmap_tpu_torch/core/renderer/renderer_nr.py`` and
``ops/grid_sample.py`` against the JAX package (hard raster in Pallas
interpret mode on the CPU).

Tolerances: 1e-5 abs for geometry, normals, grid sampling and splatting
(float32, sums in other orders); 1e-4 abs where the hard raster is involved,
with identical coverage (see ``tests/test_torch_raster.py``).  The images
resampled by a warp are smooth, as rendered textures are: the splat's
scatter adds in another order, which moves a sampling coordinate by ~1e-5
pixel (fx ~ 86 at 16 px), and per-pixel noise would turn that into 3e-5.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deep3dmap_tpu.core.renderer import renderer_nr as JR
from deep3dmap_tpu.ops.grid_sample import grid_sample_2d as jgrid_sample_2d
from deep3dmap_tpu_torch.core.renderer import renderer_nr as TR
from deep3dmap_tpu_torch.ops.grid_sample import grid_sample_2d

torch.set_num_threads(2)
S = 16
CFG = dict(min_depth=0.9, max_depth=1.1, fov=10)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(j, t, atol=1e-5):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=0)


def _pair(mode="splat"):
    cfg = dict(CFG, raster_mode=mode)
    return JR.NrRenderer(cfg, S), TR.NrRenderer(cfg, S, device="cpu")


def _depth(rng, b=2):
    """A smooth bump in [0.9, 1.1] (a face-like canonical depth)."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, S), np.linspace(-1, 1, S),
                         indexing="ij")
    amp = rng.uniform(0.05, 0.1, (b, 1, 1))
    return (1.05 - amp * np.exp(-(xx ** 2 + yy ** 2) * 2)).astype(np.float32)


def _image(rng, b=2, c=3):
    """A smooth image in [-1, 1]: a few low-frequency waves per channel."""
    yy, xx = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    f = rng.uniform(0.1, 0.4, (b, 1, 1, c))
    ph = rng.uniform(0, 2 * np.pi, (b, 1, 1, c))
    return np.sin(f * xx[None, ..., None] + ph) * np.cos(0.7 * f * yy[None, ..., None])


def _views(rng, b=2):
    return rng.uniform(-1, 1, (b, 6)).astype(np.float32) * \
        np.array([0.3, 0.3, 0.2, 0.05, 0.05, 0.05], np.float32)


def test_rotation_and_transform_matrices(rng):
    a = rng.uniform(-1, 1, (3, 4)).astype(np.float32)
    _close(JR.get_rotation_matrix(*map(jnp.asarray, a)),
           TR.get_rotation_matrix(*map(_t, a)))
    for n in (6, 5, 3):
        v = rng.uniform(-1, 1, (4, n)).astype(np.float32)
        (jR, jt), (tR, tt) = JR.get_transform_matrices(jnp.asarray(v)), \
            TR.get_transform_matrices(_t(v))
        _close(jR, tR)
        _close(jt, tt)


def test_intrinsics_and_depth_to_3d_grid(rng):
    jr, tr = _pair()
    _close(jr.K, tr.K, atol=0)
    _close(jr.inv_K, tr.inv_K, atol=1e-7)
    d = _depth(rng)
    _close(jr.depth_to_3d_grid(jnp.asarray(d)), tr.depth_to_3d_grid(_t(d)))
    v = _views(rng)
    jR, jt = JR.get_transform_matrices(jnp.asarray(v))
    tR, tt = TR.get_transform_matrices(_t(v))
    _close(jr.get_warped_2d_grid(jnp.asarray(d), jR, jt),
           tr.get_warped_2d_grid(_t(d), tR, tt))
    _close(jr.get_inv_warped_2d_grid(jnp.asarray(d), jR, jt),
           tr.get_inv_warped_2d_grid(_t(d), tR, tt))


def test_normals_from_depth(rng):
    jr, tr = _pair()
    d = _depth(rng) + rng.uniform(0, 0.01, (2, S, S)).astype(np.float32)
    _close(jr.get_normal_from_depth(jnp.asarray(d)), tr.get_normal_from_depth(_t(d)))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_2d_border_and_out_of_range(rng, mode):
    H, W = 5, 7
    img = rng.randn(H, W, 3).astype(np.float32)
    x = np.concatenate([rng.uniform(-1.5, W + 0.5, 200),
                        [0.0, W - 1, W - 1 + 1e-3, -1e-3, 0.5, W - 1.5, 3.5]])
    y = np.concatenate([rng.uniform(-1.5, H + 0.5, 200),
                        [0.0, H - 1, 2.0, 2.0, H - 1 + 1e-3, -1e-3, 2.5]])
    x, y = x.astype(np.float32), y.astype(np.float32)
    want = jgrid_sample_2d(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y), mode)
    got = grid_sample_2d(_t(img), _t(x), _t(y), mode)
    _close(want, got)
    # a sample just outside the border is zeroed whole (not blended)
    assert np.all(got.numpy()[202:206] == 0)
    np.testing.assert_array_equal(got.numpy()[201], img[H - 1, W - 1])


@pytest.mark.parametrize("mode", ["splat", "hard"])
def test_warp_canon_depth(rng, mode):
    jr, tr = _pair(mode)
    d, v = _depth(rng), _views(rng)
    jR, jt = JR.get_transform_matrices(jnp.asarray(v))
    tR, tt = TR.get_transform_matrices(_t(v))
    want = np.asarray(jr.warp_canon_depth(jnp.asarray(d), jR, jt))
    got = tr.warp_canon_depth(_t(d), tR, tt).numpy()
    if mode == "hard":
        np.testing.assert_array_equal(want != 1.1, got != 1.1, err_msg="coverage")
        assert (got == np.float32(1.1)).sum() > 0 and (got != np.float32(1.1)).sum() > 100
    np.testing.assert_allclose(got, want, atol=1e-4 if mode == "hard" else 1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["splat", "hard"])
def test_render_given_view_with_mask(rng, mode):
    jr, tr = _pair(mode)
    d, v = _depth(rng), _views(rng)
    im = _image(rng).astype(np.float32)
    mask = (rng.rand(2, S, S, 1) > 0.3).astype(np.float32)
    jw, jm = jr.render_given_view(jnp.asarray(im), jnp.asarray(d), jnp.asarray(v),
                                  mask=jnp.asarray(mask))
    tw, tm = tr.render_given_view(_t(im), _t(d), _t(v), mask=_t(mask))
    atol = 1e-4 if mode == "hard" else 1e-5
    _close(jw, tw, atol=atol)
    _close(jm, tm, atol=0)


@pytest.mark.parametrize("mode", ["splat", "hard"])
def test_render_yaw(rng, mode):
    jr, tr = _pair(mode)
    d = _depth(rng, b=1)
    im = _image(rng, b=1).astype(np.float32)
    vb = _views(rng, b=1)
    want = jr.render_yaw(jnp.asarray(im), jnp.asarray(d), v_before=jnp.asarray(vb),
                         maxr=30, nsample=3)
    got = tr.render_yaw(_t(im), _t(d), v_before=_t(vb), maxr=30, nsample=3)
    assert tuple(got.shape) == (1, 3, S, S, 3)
    _close(want, got, atol=1e-4 if mode == "hard" else 1e-5)


def test_hard_mode_gradient_flows_through_straight_through():
    tr = TR.NrRenderer(dict(CFG, raster_mode="hard"), S, device="cpu")
    depth = torch.full((1, S, S), 1.0, requires_grad=True)
    R, t = TR.get_transform_matrices(torch.tensor([[0.05, 0.1, 0.0, 0.01, 0.0, 0.0]]))
    tr.warp_canon_depth(depth, R, t).sum().backward()
    assert torch.isfinite(depth.grad).all() and depth.grad.abs().sum() > 0
