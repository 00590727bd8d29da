"""The port's focal losses, RoI ops and deformable ops
(``deep3dmap_tpu_torch/ops/{focal_loss,roi_align,deform}.py``) against the
JAX package's on the CPU, on the same seeded inputs at small sizes.

Forward outputs agree to 1e-5 and gradients (against ``jax.vjp`` with one
seeded cotangent) to 1e-4, both relative to the largest magnitude of the
JAX value.  The traps: samples past the border (the clamped band and the
zeroed outside), ``sampling_ratio=0`` and ``aligned=False``, deform groups
and conv groups, a modulation mask, a background class id ``C`` in the
sigmoid focal loss.
"""
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deep3dmap_tpu.ops import deform as jdeform
from deep3dmap_tpu.ops import focal_loss as jfocal
from deep3dmap_tpu_torch.ops import deform, focal_loss

# the packages' ``roi_align`` is the function: the modules by their paths
jroi = importlib.import_module("deep3dmap_tpu.ops.roi_align")
roi = importlib.import_module("deep3dmap_tpu_torch.ops.roi_align")

torch.set_num_threads(2)
CPU = dict(device="cpu")


def close(got, want, tol):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * scale)


def vjp_pair(jfn, tfn, args, cot_seed=0):
    """Forward and gradients of ``jfn`` (JAX) and ``tfn`` (port) on numpy
    ``args``, each differentiated in every argument under one cotangent."""
    jout, pull = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    cot = np.asarray(np.random.RandomState(cot_seed).randn(*jout.shape), np.float32)
    jg = pull(jnp.asarray(cot))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tout = tfn(*targs)
    tout.backward(torch.from_numpy(cot))
    return (np.asarray(jout), tout.detach().numpy(),
            [np.asarray(g) for g in jg], [t.grad.numpy() for t in targs])


def check(jfn, tfn, args, fwd=1e-5, grad=1e-4):
    jo, to, jg, tg = vjp_pair(jfn, tfn, args)
    assert to.shape == jo.shape
    close(to, jo, fwd)
    for a, b in zip(tg, jg):
        close(a, b, grad)


def _feat(rs, N=2, C=5, H=11, W=13):
    return rs.randn(N, C, H, W).astype(np.float32)


def _rois(rs, R, H, W, past=True):
    """[b, x1, y1, x2, y2]; with ``past`` some corners lie past the border
    (inside the clamped band and outside it)."""
    lo = -3.0 if past else 0.0
    x1 = rs.uniform(lo, W - 2, R)
    y1 = rs.uniform(lo, H - 2, R)
    x2 = x1 + rs.uniform(0.5, W / 2 + (3 if past else 0), R)
    y2 = y1 + rs.uniform(0.5, H / 2 + (3 if past else 0), R)
    b = rs.randint(0, 2, R)
    return np.stack([b, x1, y1, x2, y2], 1).astype(np.float32)


# ------------------------------------------------------------ focal loss --
@pytest.mark.parametrize("reduction,avg", [("mean", None), ("sum", None), ("none", None),
                                           ("mean", 7.5)])
def test_sigmoid_focal_loss(reduction, avg):
    rs = np.random.RandomState(0)
    N, C = 40, 6
    pred = (rs.randn(N, C) * 3).astype(np.float32)
    target = rs.randint(0, C + 1, N)                  # C: background, a zero row
    weight = rs.rand(N).astype(np.float32)
    jf = lambda p: jfocal.sigmoid_focal_loss(p, jnp.asarray(target), weight=jnp.asarray(weight),
                                              reduction=reduction, avg_factor=avg)
    tf = lambda p: focal_loss.sigmoid_focal_loss(p, torch.from_numpy(target),
                                                 weight=torch.from_numpy(weight),
                                                 reduction=reduction, avg_factor=avg)
    check(jf, tf, [pred])


@pytest.mark.parametrize("gamma,alpha", [(2.0, 0.25), (1.5, 0.5)])
def test_softmax_focal_loss(gamma, alpha):
    rs = np.random.RandomState(1)
    pred = (rs.randn(30, 7) * 2).astype(np.float32)
    target = rs.randint(0, 7, 30)
    jf = lambda p: jfocal.softmax_focal_loss(p, jnp.asarray(target), gamma, alpha,
                                              reduction="sum")
    tf = lambda p: focal_loss.softmax_focal_loss(p, torch.from_numpy(target), gamma, alpha,
                                                 reduction="sum")
    check(jf, tf, [pred])


def test_focal_loss_numpy_on_cpu():
    rs = np.random.RandomState(2)
    pred = rs.randn(8, 3).astype(np.float32)
    out = focal_loss.sigmoid_focal_loss(pred, rs.randint(0, 3, 8), **CPU)
    assert out.device.type == "cpu" and out.ndim == 0


# -------------------------------------------------------------- RoI ops --
@pytest.mark.parametrize("sr,aligned,scale", [(0, True, 1.0), (0, False, 0.5), (3, True, 0.5),
                                              (2, False, 1.0)])
def test_roi_align(sr, aligned, scale):
    rs = np.random.RandomState(3)
    feat = _feat(rs)
    rois = _rois(rs, 9, 11 / scale, 13 / scale)
    if not aligned:
        rois[0, 3:5] = rois[0, 1:3] + 0.3             # under one pixel: clamped to 1
    jf = lambda f: jroi.roi_align(f, jnp.asarray(rois), (3, 4), scale, sr, aligned)
    tf = lambda f: roi.roi_align(f, torch.from_numpy(rois), (3, 4), scale, sr, aligned)
    check(jf, tf, [feat])


def test_roi_pool():
    rs = np.random.RandomState(4)
    feat = _feat(rs)
    rois = _rois(rs, 8, 22, 26) * np.float32([1, 1, 1, 1, 1])
    jf = lambda f: jroi.roi_pool(f, jnp.asarray(rois), 3, 0.5)
    tf = lambda f: roi.roi_pool(f, torch.from_numpy(rois), 3, 0.5)
    check(jf, tf, [feat])


@pytest.mark.parametrize("clockwise,aligned,sr", [(False, True, 0), (True, False, 2)])
def test_roi_align_rotated(clockwise, aligned, sr):
    rs = np.random.RandomState(5)
    feat = _feat(rs)
    R = 7
    rois = np.stack([rs.randint(0, 2, R), rs.uniform(-1, 14, R), rs.uniform(-1, 12, R),
                     rs.uniform(0.5, 9, R), rs.uniform(0.5, 7, R),
                     rs.uniform(-np.pi, np.pi, R)], 1).astype(np.float32)
    jf = lambda f: jroi.roi_align_rotated(f, jnp.asarray(rois), (4, 3), 1.0, sr, aligned,
                                          clockwise)
    tf = lambda f: roi.roi_align_rotated(f, torch.from_numpy(rois), (4, 3), 1.0, sr, aligned,
                                         clockwise)
    check(jf, tf, [feat])


def test_bilinear_border_rule():
    """Inside (-1, H) the coordinate is clamped and sampled; outside it the
    sample is 0 (not a blend of the in-range taps)."""
    from deep3dmap_tpu_torch.ops._sampling import bilinear, feature_rows
    f = torch.arange(12, dtype=torch.float32).reshape(1, 1, 3, 4) + 1
    y = torch.tensor([-0.5, -1.0, 0.0, 2.5, 3.0, 1.5])
    x = torch.tensor([1.0, 1.0, -0.5, 3.5, 1.0, 4.0])
    got = bilinear(feature_rows(f), 3, 4, torch.zeros((), dtype=torch.int64), y, x)[:, 0]
    # clamped (0, 1) -> 2; y = -1 -> 0; clamped (0, 0) -> 1; clamped (2, 3) -> 12;
    # y = H -> 0; x = W -> 0
    assert got.tolist() == [2.0, 0.0, 1.0, 12.0, 0.0, 0.0]


# ------------------------------------------------------ deformable ops --
@pytest.mark.parametrize("groups,dg,stride,pad,dil", [(1, 1, 1, 1, 1), (2, 2, 2, 1, 1),
                                                      (1, 2, 1, 2, 2)])
def test_deform_conv2d(groups, dg, stride, pad, dil):
    rs = np.random.RandomState(6)
    N, C, H, W, Co, k = 2, 4, 9, 10, 6, 3
    x = rs.randn(N, C, H, W).astype(np.float32)
    Ho = (H + 2 * pad - dil * (k - 1) - 1) // stride + 1
    Wo = (W + 2 * pad - dil * (k - 1) - 1) // stride + 1
    off = (rs.randn(N, 2 * dg * k * k, Ho, Wo) * 2.5).astype(np.float32)   # past the border too
    w = (rs.randn(Co, C // groups, k, k) * 0.3).astype(np.float32)
    kw = dict(stride=stride, padding=pad, dilation=dil, groups=groups, deform_groups=dg)
    check(lambda a, o, ww: jdeform.deform_conv2d(a, o, ww, **kw),
          lambda a, o, ww: deform.deform_conv2d(a, o, ww, **kw), [x, off, w])


@pytest.mark.parametrize("dg", [1, 2])
def test_modulated_deform_conv2d(dg):
    rs = np.random.RandomState(7)
    N, C, H, W, Co, k = 2, 4, 8, 9, 5, 3
    x = rs.randn(N, C, H, W).astype(np.float32)
    off = (rs.randn(N, 2 * dg * k * k, H, W) * 2).astype(np.float32)
    m = rs.rand(N, dg * k * k, H, W).astype(np.float32)
    w = (rs.randn(Co, C, k, k) * 0.3).astype(np.float32)
    b = rs.randn(Co).astype(np.float32)
    kw = dict(padding=1, deform_groups=dg)
    check(lambda a, o, mm, ww, bb: jdeform.modulated_deform_conv2d(a, o, mm, ww, bb, **kw),
          lambda a, o, mm, ww, bb: deform.modulated_deform_conv2d(a, o, mm, ww, bb, **kw),
          [x, off, m, w, b])


@pytest.mark.parametrize("with_offset", [True, False])
def test_deform_roi_pool(with_offset):
    rs = np.random.RandomState(8)
    feat = _feat(rs)
    rois = _rois(rs, 6, 22, 26)
    off = (rs.randn(6, 2, 3, 3) * 0.5).astype(np.float32)
    if with_offset:
        check(lambda f, o: jdeform.deform_roi_pool(f, jnp.asarray(rois), o, 3, 0.5, 2, 0.1),
              lambda f, o: deform.deform_roi_pool(f, torch.from_numpy(rois), o, 3, 0.5, 2, 0.1),
              [feat, off])
    else:
        check(lambda f: jdeform.deform_roi_pool(f, jnp.asarray(rois), None, (3, 2), 0.5, 0),
              lambda f: deform.deform_roi_pool(f, torch.from_numpy(rois), None, (3, 2), 0.5, 0),
              [feat])


@pytest.mark.parametrize("shapes_as_tensor", [False, True])
def test_ms_deform_attn(shapes_as_tensor):
    rs = np.random.RandomState(9)
    shapes = [(6, 7), (3, 4), (2, 2)]
    starts = np.cumsum([0] + [h * w for h, w in shapes[:-1]])
    Lv = sum(h * w for h, w in shapes)
    N, nh, C, Lq, P = 2, 2, 3, 5, 4
    value = rs.randn(N, Lv, nh, C).astype(np.float32)
    loc = rs.uniform(-0.2, 1.2, (N, Lq, nh, len(shapes), P, 2)).astype(np.float32)
    attn = rs.rand(N, Lq, nh, len(shapes), P).astype(np.float32)
    tshapes = torch.tensor(shapes) if shapes_as_tensor else shapes
    tstarts = torch.tensor(starts) if shapes_as_tensor else starts
    check(lambda v, l, a: jdeform.ms_deform_attn(v, shapes, starts, l, a),
          lambda v, l, a: deform.ms_deform_attn(v, tshapes, tstarts, l, a),
          [value, loc, attn])


def test_zoo_entry_points_follow_the_tensor_device():
    """Tensors stay on their device; numpy goes where ``device`` says."""
    rs = np.random.RandomState(10)
    feat = _feat(rs)
    rois = _rois(rs, 3, 11, 13)
    out = roi.roi_align(torch.from_numpy(feat), torch.from_numpy(rois), 2)
    assert out.device.type == "cpu"
    out = deform.deform_roi_pool(feat, rois, None, 2, **CPU)
    assert out.device.type == "cpu" and out.shape == (3, 5, 2, 2)
