"""The port's point, voxel and 3D-box ops
(``deep3dmap_tpu_torch/ops/{points,voxel,box3d}.py``) against the JAX
package's on the CPU, on the same seeded inputs at small sizes.

Index outputs (neighbours, ball members, sampled points, voxel coordinates
and counts, box ids, keep sets) are equal; float outputs agree to 1e-5 and
gradients (``jax.vjp`` under one seeded cotangent) to 1e-4, relative to the
largest magnitude of the JAX value.  The traps: tied distances (points on an
integer grid) for ``knn``/``ball_query``, points outside the range and more
points than ``max_points``/``max_voxels``, overlapping boxes for
``points_in_boxes``, a voxel holding more points than ``max_pts_per_voxel``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deep3dmap_tpu.ops import box3d as jbox3d
from deep3dmap_tpu.ops import points as jpoints
from deep3dmap_tpu.ops import voxel as jvoxel
from deep3dmap_tpu_torch.ops import box3d, points, voxel

torch.set_num_threads(2)
CPU = dict(device="cpu")


def close(got, want, tol):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * scale)


def same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grid_cloud(rs, B, N):
    """Points on an integer grid: many exactly equal distances."""
    return rs.randint(0, 4, (B, N, 3)).astype(np.float32)


# ----------------------------------------------------------------- points --
@pytest.mark.parametrize("grid", [False, True])
def test_square_distance_and_knn(grid):
    rs = np.random.RandomState(0)
    xyz = _grid_cloud(rs, 2, 40) if grid else rs.rand(2, 40, 3).astype(np.float32)
    q = _grid_cloud(rs, 2, 9) if grid else rs.rand(2, 9, 3).astype(np.float32)
    close(points.square_distance(_t(q), _t(xyz)), jpoints.square_distance(q, xyz), 1e-5)
    jd, ji = jpoints.knn(6, jnp.asarray(xyz), jnp.asarray(q))
    td, ti = points.knn(6, _t(xyz), _t(q))
    same(ti, ji)
    close(td, jd, 1e-5)


@pytest.mark.parametrize("grid,radius", [(False, 0.3), (True, 1.5), (True, 0.5)])
def test_ball_query(grid, radius):
    rs = np.random.RandomState(1)
    xyz = _grid_cloud(rs, 2, 50) if grid else rs.rand(2, 50, 3).astype(np.float32)
    q = _grid_cloud(rs, 2, 12) if grid else rs.rand(2, 12, 3).astype(np.float32)
    q[0, 0] = 100.0                                   # an empty ball
    same(points.ball_query(radius, 8, _t(xyz), _t(q)),
         jpoints.ball_query(radius, 8, jnp.asarray(xyz), jnp.asarray(q)))


@pytest.mark.parametrize("grid", [False, True])
def test_furthest_point_sample(grid):
    rs = np.random.RandomState(2)
    xyz = _grid_cloud(rs, 3, 64) if grid else rs.rand(3, 64, 3).astype(np.float32)
    same(points.furthest_point_sample(_t(xyz), 20),
         jpoints.furthest_point_sample(jnp.asarray(xyz), 20))


def test_gather_group_and_three_interpolate():
    rs = np.random.RandomState(3)
    B, C, N, M, K = 2, 5, 30, 7, 4
    feats = rs.randn(B, C, N).astype(np.float32)
    idx = rs.randint(0, N, (B, M))
    gidx = rs.randint(0, N, (B, M, K))
    for jfn, tfn, ix, shape in ((jpoints.gather_points, points.gather_points, idx, (B, C, M)),
                                (jpoints.group_points, points.group_points, gidx,
                                 (B, C, M, K))):
        c = rs.randn(*shape).astype(np.float32)
        jo, pull = jax.vjp(lambda f: jfn(f, jnp.asarray(ix)), jnp.asarray(feats))
        f = _t(feats).requires_grad_()
        to = tfn(f, _t(ix))
        to.backward(_t(c))
        close(to.detach(), jo, 1e-5)
        close(f.grad, pull(jnp.asarray(c))[0], 1e-4)
    unknown = rs.rand(B, 12, 3).astype(np.float32)
    known = rs.rand(B, N, 3).astype(np.float32)
    jd, ji = jpoints.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    td, ti = points.three_nn(_t(unknown), _t(known))
    same(ti, ji)
    close(td, jd, 1e-5)
    jiw, jw = jpoints.three_interpolate_weights(jnp.asarray(unknown), jnp.asarray(known))
    tiw, tw = points.three_interpolate_weights(_t(unknown), _t(known))
    same(tiw, jiw)
    close(tw, jw, 1e-5)
    c = rs.randn(B, C, 12).astype(np.float32)
    jo, pull = jax.vjp(lambda f, w: jpoints.three_interpolate(f, jiw, w),
                       jnp.asarray(feats), jw)
    f, w = _t(feats).requires_grad_(), tw.clone().requires_grad_()
    to = points.three_interpolate(f, tiw, w)
    to.backward(_t(c))
    close(to.detach(), jo, 1e-5)
    jgf, jgw = pull(jnp.asarray(c))
    close(f.grad, jgf, 1e-4)
    close(w.grad, jgw, 1e-4)


# ------------------------------------------------------------------ voxel --
VS, RANGE = (0.5, 0.5, 1.0), (0.0, -2.0, -1.0, 4.0, 2.0, 1.0)


def _cloud(rs, n):
    """Points inside and outside RANGE, some voxels crowded."""
    p = rs.uniform([-1, -3, -2, 0], [5, 3, 2, 1], (n, 4)).astype(np.float32)
    p[: n // 4, :3] = np.float32([1.1, 0.2, 0.3]) + rs.rand(n // 4, 3).astype(np.float32) * 0.1
    return p


@pytest.mark.parametrize("max_points,max_voxels", [(5, 40), (3, 8), (64, 200)])
def test_voxelize(max_points, max_voxels):
    rs = np.random.RandomState(4)
    pts = _cloud(rs, 300)
    jv = jvoxel.voxelize(jnp.asarray(pts), VS, RANGE, max_points, max_voxels)
    tv = voxel.voxelize(_t(pts), VS, RANGE, max_points, max_voxels)
    for a, b in zip(tv, jv):
        same(a, b)
    host = voxel.voxelize_host(pts, VS, RANGE, max_points, max_voxels, **CPU)
    for a, b in zip(host, jvoxel.voxelize_host(pts, VS, RANGE, max_points, max_voxels)):
        assert isinstance(a, np.ndarray)
        same(a, b)


@pytest.mark.parametrize("reduce_op,max_voxels", [("mean", 64), ("max", 64), ("sum", 64),
                                                  ("mean", 5)])
def test_dynamic_scatter(reduce_op, max_voxels):
    rs = np.random.RandomState(5)
    N, C = 200, 6
    feats = rs.randn(N, C).astype(np.float32)
    coors = rs.randint(0, 4, (N, 3)).astype(np.int32)
    coors[rs.rand(N) < 0.1, 1] = -1                   # invalid points
    jout, pull = jax.vjp(lambda f: jvoxel.dynamic_scatter(f, jnp.asarray(coors), reduce_op,
                                                          max_voxels)[0], jnp.asarray(feats))
    _, jc, jn = jvoxel.dynamic_scatter(jnp.asarray(feats), jnp.asarray(coors), reduce_op,
                                       max_voxels)
    f = _t(feats).requires_grad_()
    tout, tc, tn = voxel.dynamic_scatter(f, _t(coors), reduce_op, max_voxels)
    same(tc, jc)
    same(tn, jn)
    close(tout.detach(), jout, 1e-5)
    c = rs.randn(*jout.shape).astype(np.float32)
    tout.backward(_t(c))
    close(f.grad, pull(jnp.asarray(c))[0], 1e-4)


def test_points_in_boxes_overlapping():
    rs = np.random.RandomState(6)
    B, N, T = 2, 300, 6
    pts = rs.uniform(-4, 4, (B, N, 3)).astype(np.float32)
    boxes = np.concatenate([rs.uniform(-2, 2, (B, T, 3)), rs.uniform(1, 4, (B, T, 3)),
                            rs.uniform(-np.pi, np.pi, (B, T, 1))], -1).astype(np.float32)
    boxes[:, 1] = boxes[:, 0]                         # an identical pair: the first wins
    out = voxel.points_in_boxes(_t(pts), _t(boxes))
    same(out, jvoxel.points_in_boxes(jnp.asarray(pts), jnp.asarray(boxes)))
    assert (out.numpy() >= 0).sum() > 50 and (out.numpy() == 1).sum() == 0   # 1: shadowed by 0


# ------------------------------------------------------------------ box3d --
def _boxes3d(rs, n, span=20.0):
    return np.concatenate([rs.uniform(0, span, (n, 2)), rs.uniform(-1, 1, (n, 1)),
                           rs.uniform(1, 5, (n, 3)), rs.uniform(-np.pi, np.pi, (n, 1))],
                          1).astype(np.float32)


def test_box_ious():
    rs = np.random.RandomState(7)
    a, b = _boxes3d(rs, 30), _boxes3d(rs, 20)
    b[:5] = a[:5]
    for jfn, tfn in ((jbox3d.boxes_iou_bev, box3d.boxes_iou_bev),
                     (jbox3d.boxes_overlap_bev, box3d.boxes_overlap_bev),
                     (jbox3d.boxes_iou3d, box3d.boxes_iou3d)):
        close(tfn(_t(a), _t(b)), jfn(a, b), 1e-5)


@pytest.mark.parametrize("thr", [0.1, 0.5])
def test_nms3d(thr):
    rs = np.random.RandomState(8)
    boxes = _boxes3d(rs, 80, span=12.0)
    scores = rs.rand(80).astype(np.float32)
    scores[10:14] = scores[0]                         # ties: index order
    keep = box3d.nms3d(_t(boxes), _t(scores), thr)
    assert keep.dtype == torch.int64 and keep.device.type == "cpu"
    same(keep, jbox3d.nms3d(boxes, scores, thr))
    same(box3d.nms3d_normal(boxes, scores, thr, **CPU), jbox3d.nms3d_normal(boxes, scores, thr))


@pytest.mark.parametrize("mode,out_size", [("max", (3, 2, 2)), ("avg", (2, 3, 4))])
def test_roiaware_pool3d(mode, out_size):
    rs = np.random.RandomState(9)
    rois = _boxes3d(rs, 5, span=3.0)
    pts = np.concatenate([rs.uniform(-1, 4, (300, 3)),
                          np.repeat(rois[:1, :3], 40, 0)]).astype(np.float32)  # a crowded voxel
    feats = rs.randn(len(pts), 4).astype(np.float32)
    out = box3d.roiaware_pool3d(_t(rois), _t(pts), _t(feats), out_size, max_pts_per_voxel=8,
                                mode=mode)
    close(out, jbox3d.roiaware_pool3d(jnp.asarray(rois), jnp.asarray(pts), jnp.asarray(feats),
                                      out_size, max_pts_per_voxel=8, mode=mode), 1e-5)


@pytest.mark.parametrize("S", [16, 90])
def test_roipoint_pool3d(S):
    rs = np.random.RandomState(10)
    B, N, T = 2, 60, 4
    pts = rs.uniform(0, 3, (B, N, 3)).astype(np.float32)
    feats = rs.randn(B, N, 2).astype(np.float32)
    boxes = np.concatenate([_boxes3d(rs, T, span=3.0)[None] for _ in range(B)])
    boxes[0, 0, :3] = 50.0                            # an empty box
    jp, je = jbox3d.roipoint_pool3d(jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(boxes), S)
    tp, te = box3d.roipoint_pool3d(_t(pts), _t(feats), _t(boxes), S)
    same(te, je)
    same(tp, jp)
