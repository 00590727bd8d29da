"""The port's dense-vision ops, host ops, ``grid_sample_3d`` and the
unbatched back-projections (``deep3dmap_tpu_torch/ops/{vision,host,
grid_sample,back_project}.py``) against the JAX package's on the CPU, on the
same seeded inputs at small sizes.

Float outputs agree to 1e-5 and gradients (``jax.vjp`` under one seeded
cotangent) to 1e-4, relative to the largest magnitude of the JAX value; the
host ops' outputs are equal.  The traps: CARAFE taps past the border,
correlation's wrapping rolls with a kernel wider than 1, PSA windows
clipped at the border, border-align tracks that leave the image, and
``grid_sample_3d`` samples outside the volume (``fill``).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deep3dmap_tpu.ops import back_project as jbp
from deep3dmap_tpu.ops import grid_sample as jgs
from deep3dmap_tpu.ops import host as jhost
from deep3dmap_tpu.ops import vision as jvision
from deep3dmap_tpu_torch.ops import back_project, grid_sample, host, vision

torch.set_num_threads(2)


def close(got, want, tol):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * scale)


def check(jfn, tfn, args, fwd=1e-5, grad=1e-4):
    jout, pull = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    cot = np.asarray(np.random.RandomState(0).randn(*jout.shape), np.float32)
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tout = tfn(*targs)
    tout.backward(torch.from_numpy(cot))
    close(tout.detach(), jout, fwd)
    for t, g in zip(targs, pull(jnp.asarray(cot))):
        close(t.grad, g, grad)


@pytest.mark.parametrize("k,group,scale", [(5, 1, 2), (3, 2, 3)])
def test_carafe(k, group, scale):
    rs = np.random.RandomState(0)
    N, C, H, W = 2, 4, 5, 6
    feat = rs.randn(N, C, H, W).astype(np.float32)
    masks = rs.rand(N, group * k * k, H * scale, W * scale).astype(np.float32)
    check(lambda f, m: jvision.carafe(f, m, k, group, scale),
          lambda f, m: vision.carafe(f, m, k, group, scale), [feat, masks])
    close(vision.carafe_naive(feat, masks, k, group, scale, device="cpu"),
          jvision.carafe_naive(feat, masks, k, group, scale), 1e-5)


def test_masked_conv2d():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 3, 7, 8).astype(np.float32)
    mask = (rs.rand(2, 7, 8) > 0.6).astype(np.float32)
    w = rs.randn(4, 3, 3, 3).astype(np.float32)
    b = rs.randn(4).astype(np.float32)
    check(lambda xx, ww, bb: jvision.masked_conv2d(xx, jnp.asarray(mask), ww, bb),
          lambda xx, ww, bb: vision.masked_conv2d(xx, torch.from_numpy(mask), ww, bb),
          [x, w, b])


@pytest.mark.parametrize("k,d,stride,pad,dil,dp", [(1, 2, 1, 0, 1, 1), (3, 1, 2, 1, 1, 2)])
def test_correlation(k, d, stride, pad, dil, dp):
    rs = np.random.RandomState(2)
    a = rs.randn(2, 3, 7, 9).astype(np.float32)
    b = rs.randn(2, 3, 7, 9).astype(np.float32)
    kw = dict(kernel_size=k, max_displacement=d, stride=stride, padding=pad, dilation=dil,
              dilation_patch=dp)
    check(lambda x, y: jvision.correlation(x, y, **kw),
          lambda x, y: vision.correlation(x, y, **kw), [a, b])


def test_tin_shift():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 5, 8, 6).astype(np.float32)
    shift = rs.randint(-3, 4, (2, 4))
    close(vision.tin_shift(torch.from_numpy(x), torch.from_numpy(shift)),
          jvision.tin_shift(jnp.asarray(x), jnp.asarray(shift)), 1e-6)


@pytest.mark.parametrize("psa_type", ["collect", "distribute"])
def test_psamask(psa_type):
    rs = np.random.RandomState(4)
    H, W, mh, mw = 5, 6, 5, 7
    x = rs.randn(2, mh * mw, H, W).astype(np.float32)
    close(vision.psamask(torch.from_numpy(x), psa_type, mh, mw),
          jvision.psamask(jnp.asarray(x), psa_type, mh, mw), 1e-6)


def test_border_align():
    rs = np.random.RandomState(5)
    N, C, H, W, B = 2, 3, 9, 10, 5
    feat = rs.randn(N, 4 * C, H, W).astype(np.float32)
    xy = rs.uniform(-2, 7, (N, B, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(1, 6, (N, B, 2))], -1).astype(np.float32)
    check(lambda f: jvision.border_align(f, jnp.asarray(boxes), 4),
          lambda f: vision.border_align(f, torch.from_numpy(boxes), 4), [feat])


@pytest.mark.parametrize("mode", ["top", "bottom", "left", "right"])
def test_corner_pool(mode):
    x = np.random.RandomState(6).randn(2, 3, 6, 7).astype(np.float32)
    np.testing.assert_array_equal(vision.corner_pool(torch.from_numpy(x), mode).numpy(),
                                  np.asarray(jvision.corner_pool(jnp.asarray(x), mode)))


# -------------------------------------------------------------- host ops --
def _text_maps(rs, H=24, W=30):
    label = np.zeros((H, W), np.int32)
    label[3:7, 4:12] = 1
    label[14:18, 8:20] = 2
    label[10:12, 24:27] = 3
    mask = rs.rand(H, W) > 0.3
    mask[label > 0] = True
    return label, mask


def test_pixel_group():
    rs = np.random.RandomState(7)
    label, mask = _text_maps(rs)
    score = rs.rand(*label.shape).astype(np.float32)
    emb = rs.randn(*label.shape, 4).astype(np.float32) * 0.3
    contour = np.zeros(label.shape, np.uint8)
    contour[label > 0] = 1
    args = (score, mask, emb, label, contour, 4, 0.8)
    want = jhost.pixel_group(*args)
    assert host.pixel_group(*args) == want
    assert host.pixel_group(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                              for a in args]) == want


def test_contour_expand():
    rs = np.random.RandomState(8)
    label, mask = _text_maps(rs)
    kernels = np.stack([mask, np.pad(label > 0, 0)]).astype(np.uint8)
    kernels = np.concatenate([kernels[:1], kernels[:1] & (rs.rand(*label.shape) > 0.2),
                              kernels[1:]]).astype(np.uint8)
    want = jhost.contour_expand(kernels, label, 10, 3)
    assert host.contour_expand(kernels, label, 10, 3) == want
    assert host.contour_expand(torch.from_numpy(kernels), torch.from_numpy(label), 10, 3) == want


# ------------------------------------------------------- grid_sample_3d --
@pytest.mark.parametrize("mode,channels,fill", [("bilinear", 3, 0.0), ("bilinear", 0, -1.0),
                                                ("nearest", 2, 0.5)])
def test_grid_sample_3d(mode, channels, fill):
    rs = np.random.RandomState(9)
    shape = (5, 6, 4) + ((channels,) if channels else ())
    vol = rs.randn(*shape).astype(np.float32)
    x, y, z = (rs.uniform(-1, n, (3, 7)).astype(np.float32) for n in (5, 6, 4))
    if mode == "nearest":
        close(grid_sample.grid_sample_3d(*(torch.from_numpy(a) for a in (vol, x, y, z)),
                                         mode=mode, fill=fill),
              jgs.grid_sample_3d(*(jnp.asarray(a) for a in (vol, x, y, z)), mode=mode,
                                 fill=fill), 1e-6)
        return
    check(lambda v, a, b, c: jgs.grid_sample_3d(v, a, b, c, mode=mode, fill=fill),
          lambda v, a, b, c: grid_sample.grid_sample_3d(v, a, b, c, mode=mode, fill=fill),
          [vol, x, y, z])


# ----------------------------------------------- unbatched back-projections --
@pytest.fixture(scope="module")
def fragment():
    from deep3dmap_tpu.datasets.synthetic import make_fragment_sample
    s = make_fragment_sample(seed=1, n_views=3, img_size=(32, 32), n_vox=24, voxel_size=0.08)
    rs = np.random.RandomState(10)
    feats = rs.randn(3, 8, 8, 5).astype(np.float32)
    return feats, s["proj_matrices"][:, 1], s["vol_origin_partial"] + np.float32(0.05)


def test_back_project_unbatched(fragment):
    feats, proj, origin = fragment
    dim, vs, interval = 12, 0.08, 2
    j = [jnp.asarray(a) for a in (feats, proj, origin)]
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (feats, proj, origin)]
    for a, b in zip(back_project.back_project_dense(*t, dim, vs, interval),
                    jbp.back_project_dense(*j, dim, vs, interval)):
        close(a, b, 1e-5)
    mask = np.random.RandomState(11).rand(dim, dim, dim) > 0.7
    for a, b in zip(back_project.back_project_masked(*t, torch.from_numpy(mask), 300, dim, vs,
                                                     interval),
                    jbp.back_project_masked(*j, jnp.asarray(mask), 300, dim, vs, interval)):
        close(a, b, 1e-5)
    idx = np.arange(0, dim ** 3, 7).astype(np.int32)
    valid = np.arange(len(idx)) < len(idx) - 9
    for a, b in zip(back_project.back_project_sparse(*t, torch.from_numpy(idx).long(),
                                                     torch.from_numpy(valid), dim, vs,
                                                     interval),
                    jbp.back_project_sparse(*j, jnp.asarray(idx), jnp.asarray(valid), dim, vs,
                                            interval)):
        close(a, b, 1e-5)
