"""The port's box ops (``deep3dmap_tpu_torch/ops/bbox.py``) against the JAX
package's ``ops/bbox.py`` on the CPU, on the same seeded boxes (64-512):

* ``bbox_overlaps`` (IoU and IoF, pairwise and aligned, offset 0 and 1):
  1e-6 (measured: equal bit for bit);
* ``nms``, ``batched_nms``, ``nms_rotated``: the same keep sets in the same
  order, score ties included; the dets equal;
* ``soft_nms`` linear and gaussian: the same kept indices, scores 1e-6
  (measured 0 and 9e-8: XLA's and torch's float32 ``exp``);
* ``nms_match``: the same groups;
* ``box_iou_rotated``: IoU 1e-5 (measured 4.3e-6), with parallel and
  touching edges checked against their exact values too; IoF as its test
  says.
"""
import numpy as np
import pytest
import torch

from deep3dmap_tpu.ops import bbox as jbbox
from deep3dmap_tpu_torch.ops import bbox

CPU = dict(device="cpu")


def _boxes(rs, n, span=100.0, size=40.0):
    xy = rs.rand(n, 2) * span
    wh = rs.rand(n, 2) * size + 1
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _scores(rs, n, ties=True):
    s = rs.rand(n).astype(np.float32)
    if ties:                      # equal scores: the order falls back to the index
        s[: n // 8] = s[n // 8: 2 * (n // 8)]
        s[-4:] = s[0]
    return s


def _rotated(rs, n):
    return np.concatenate([rs.rand(n, 2) * 100, rs.rand(n, 2) * 30 + 2,
                           rs.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)


@pytest.mark.parametrize("n", [64, 512])
def test_bbox_overlaps(n):
    rs = np.random.RandomState(n)
    a, b = _boxes(rs, n), _boxes(rs, n // 2)
    for mode in ("iou", "iof"):
        for offset in (0, 1):
            out = bbox.bbox_overlaps(a, b, mode=mode, offset=offset, **CPU)
            assert out.dtype == torch.float32 and out.device.type == "cpu"
            np.testing.assert_allclose(
                out.numpy(), np.asarray(jbbox.bbox_overlaps(a, b, mode=mode, offset=offset)),
                rtol=0, atol=1e-6)
    al = bbox.bbox_overlaps(a[: n // 2], b, aligned=True, **CPU).numpy()
    np.testing.assert_allclose(al, np.asarray(jbbox.bbox_overlaps(a[: n // 2], b, aligned=True)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,thr,offset", [(64, 0.5, 0), (300, 0.3, 1), (512, 0.7, 0)])
def test_nms_keeps_jax_set(n, thr, offset):
    rs = np.random.RandomState(n)
    b, s = _boxes(rs, n), _scores(rs, n)
    dj, kj = jbbox.nms(b, s, thr, offset=offset)
    dt, kt = bbox.nms(torch.from_numpy(b), torch.from_numpy(s), thr, offset=offset)
    assert kt.dtype == torch.int64
    np.testing.assert_array_equal(kt.numpy(), kj)
    np.testing.assert_array_equal(dt.numpy(), dj)


def test_nms_empty_and_all_tied():
    dt, kt = bbox.nms(np.zeros((0, 4), np.float32), np.zeros(0, np.float32), 0.5, **CPU)
    assert dt.shape == (0, 5) and kt.shape == (0,)
    b = np.tile(np.array([[0, 0, 10, 10]], np.float32), (5, 1))
    b[:, 0] += np.arange(5)
    s = np.ones(5, np.float32)
    np.testing.assert_array_equal(bbox.nms(b, s, 0.5, **CPU)[1].numpy(), jbbox.nms(b, s, 0.5)[1])


@pytest.mark.parametrize("n,classes", [(256, 80), (512, 5)])
def test_batched_nms(n, classes):
    rs = np.random.RandomState(classes)
    b, s = _boxes(rs, n), _scores(rs, n)
    idx = rs.randint(0, classes, n)
    for agnostic in (False, True):
        dj, kj = jbbox.batched_nms(b, s, idx, 0.5, class_agnostic=agnostic)
        dt, kt = bbox.batched_nms(b, s, idx, 0.5, class_agnostic=agnostic, **CPU)
        np.testing.assert_array_equal(kt.numpy(), kj)
        np.testing.assert_array_equal(dt.numpy(), dj)


@pytest.mark.parametrize("method", ["linear", "gaussian"])
@pytest.mark.parametrize("n", [64, 300])
def test_soft_nms(method, n):
    rs = np.random.RandomState(n + len(method))
    b, s = _boxes(rs, n, size=60.0), _scores(rs, n)
    dj, kj = jbbox.soft_nms(b, s, iou_threshold=0.3, sigma=0.5, min_score=0.05, method=method)
    dt, kt = bbox.soft_nms(b, s, iou_threshold=0.3, sigma=0.5, min_score=0.05, method=method,
                           **CPU)
    np.testing.assert_array_equal(kt.numpy(), kj)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=0, atol=1e-6)


def test_nms_match():
    rs = np.random.RandomState(3)
    b, s = _boxes(rs, 200, size=50.0), _scores(rs, 200)
    dets = np.concatenate([b, s[:, None]], 1)
    gj, gt = jbbox.nms_match(dets, 0.4), bbox.nms_match(dets, 0.4, **CPU)
    assert len(gj) == len(gt) > 1
    for a, t in zip(gj, gt):
        np.testing.assert_array_equal(t.numpy(), a)
    assert bbox.nms_match(np.zeros((0, 5), np.float32), 0.5, **CPU) == []


def _iof64(r1, r2):
    """Rotated IoF in float64: the port's pair function on double tensors."""
    n, m = len(r1), len(r2)
    b1 = torch.from_numpy(r1).double()[:, None].expand(n, m, 5).reshape(-1, 5)
    b2 = torch.from_numpy(r2).double()[None].expand(n, m, 5).reshape(-1, 5)
    return bbox._pairs_rotated_iou(b1, b2, "iof").view(n, m).numpy()


@pytest.mark.parametrize("n", [64, 512])
def test_box_iou_rotated(n):
    """IoU: 1e-5 against JAX (measured 4.4e-6).  IoF divides by the first
    box's own area, which for a small box far from the origin amplifies the
    float32 rounding of JAX's shoelace sum at absolute coordinates (products
    near 5,400, ulp 4.9e-4): JAX sits up to 2.9e-5 from the same clip in
    float64 here, the port, which clips relative to the first box's centre,
    3.2e-7 (``ROADMAP.md`` Queue 3).  So IoF is held to float64 at 1e-5 and
    to JAX at JAX's own distance from float64 plus 1e-5."""
    rs = np.random.RandomState(n + 1)
    r1, r2 = _rotated(rs, n), _rotated(rs, 96)
    np.testing.assert_allclose(bbox.box_iou_rotated(r1, r2, **CPU).numpy(),
                               np.asarray(jbbox.box_iou_rotated(r1, r2)), rtol=0, atol=1e-5)
    iof = bbox.box_iou_rotated(r1, r2, mode="iof", **CPU).numpy()
    iof_jax, iof64 = np.asarray(jbbox.box_iou_rotated(r1, r2, mode="iof")), _iof64(r1, r2)
    np.testing.assert_allclose(iof, iof64, rtol=0, atol=1e-5)
    np.testing.assert_allclose(iof, iof_jax, rtol=0, atol=np.abs(iof_jax - iof64).max() + 1e-5)
    k = min(n, 96)
    np.testing.assert_allclose(
        bbox.box_iou_rotated(r1[:k], r2[:k], aligned=True, **CPU).numpy(),
        np.asarray(jbbox.box_iou_rotated(r1[:k], r2[:k], aligned=True)), rtol=0, atol=1e-5)


def test_box_iou_rotated_parallel_and_touching_edges():
    a = np.array([[0, 0, 4, 2, 0]] * 6, np.float32)
    b = np.array([
        [4, 0, 4, 2, 0],              # touching along a shared edge: 0
        [2, 0, 4, 2, 0],              # parallel edges, half overlap: 4 / 12
        [0, 0, 4, 2, np.pi],          # the same box turned half a turn: 1
        [0, 0, 2, 4, np.pi / 2],      # the same box turned a quarter: 1
        [0, 2, 4, 2, 0],              # touching along the long edge: 0
        [1, 0.5, 2, 1, 0],            # inside, parallel edges: 2 / 8
    ], np.float32)
    exact = np.array([0, 1 / 3, 1, 1, 0, 0.25], np.float32)
    t = bbox.box_iou_rotated(a, b, aligned=True, **CPU).numpy()
    np.testing.assert_allclose(t, np.asarray(jbbox.box_iou_rotated(a, b, aligned=True)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(t, exact, rtol=0, atol=1e-5)


def test_nms_rotated():
    rs = np.random.RandomState(9)
    r, s = _rotated(rs, 256), _scores(rs, 256)
    dj, kj = jbbox.nms_rotated(r, s, 0.3)
    dt, kt = bbox.nms_rotated(r, s, 0.3, **CPU)
    np.testing.assert_array_equal(kt.numpy(), kj)
    np.testing.assert_array_equal(dt.numpy(), dj)


def test_tensors_stay_on_their_device_and_the_package_exports():
    from deep3dmap_tpu_torch import ops

    b = torch.tensor([[0, 0, 10, 10], [1, 1, 10, 10]], dtype=torch.float64)
    out = ops.bbox_overlaps(b, b, device="cuda")     # a tensor's device wins
    assert out.device.type == "cpu" and out.dtype == torch.float32
    # the box ops among the package's exports, which are JAX's whole
    # ``ops.__all__`` since the op zoo (tests/test_torch_port_rules.py)
    assert {"bbox_overlaps", "nms", "soft_nms", "batched_nms", "nms_match", "nms_rotated",
            "box_iou_rotated"} <= set(ops.__all__)
    assert ops.nms is bbox.nms
