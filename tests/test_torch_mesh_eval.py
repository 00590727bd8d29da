"""The port's mesh and evaluation path against the JAX package's, on the CPU:
PLY files, marching tetrahedra (numpy and the C++ host op), the scene
assembler, the depth metrics, the point F-score, the host depth rasterizer
and ``ScanNetDataset.evaluate`` on the same ``.ply`` files.

Every comparison is exact: the port's modules are copies of numpy code and
of the same C++ source (``ops/csrc/native.cpp``), run on the same inputs.
"""
import os.path as osp

import numpy as np
import pytest

import deep3dmap_tpu.native as jax_native
from deep3dmap_tpu.core.evaluation import eval_depth as jax_eval_depth
from deep3dmap_tpu.core.evaluation import eval_fscore_points as jax_eval_fscore
from deep3dmap_tpu.core.utils import io_ply as jax_ply
from deep3dmap_tpu.core.utils import marching_cubes as jax_mc
from deep3dmap_tpu.core.utils.scene_assembler import SceneAssembler as JaxAssembler
from deep3dmap_tpu.datasets.scannet import ScanNetDataset as JaxScanNetDataset
from deep3dmap_tpu.datasets.synthetic import write_scannet_fixture as jax_write_fixture

from deep3dmap_tpu_torch.core.evaluation.depth_eval import eval_depth
from deep3dmap_tpu_torch.core.evaluation.mesh_eval import eval_fscore_points
from deep3dmap_tpu_torch.core.utils import io_ply, marching_cubes
from deep3dmap_tpu_torch.core.utils.scene_assembler import SceneAssembler
from deep3dmap_tpu_torch.datasets.scannet import ScanNetDataset
from deep3dmap_tpu_torch.ops import native

SCENE = "scene0707_00"


def _sphere_tsdf(n=20, r=6.0, seed=0):
    rs = np.random.RandomState(seed)
    g = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1).astype(np.float32)
    d = np.linalg.norm(g - (n / 2 + rs.uniform(-1, 1, 3)), axis=-1) - r
    return np.clip(d / 3.0, -1, 1).astype(np.float32)


def test_native_builds_here():
    assert native.available() and jax_native.available()


def test_ply_roundtrip_across_packages(tmp_path):
    rs = np.random.RandomState(0)
    verts = rs.rand(50, 3).astype(np.float32)
    faces = rs.randint(0, 50, (30, 3))
    io_ply.write_ply(str(tmp_path / "p.ply"), verts, faces)
    jax_ply.write_ply(str(tmp_path / "j.ply"), verts, faces)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    for v, f in (io_ply.read_ply(str(tmp_path / "j.ply")),
                 jax_ply.read_ply(str(tmp_path / "p.ply"))):
        np.testing.assert_array_equal(v, verts)
        np.testing.assert_array_equal(f, faces)
    ascii_ply = ("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\nproperty float y\n"
                 "property float z\nelement face 1\nproperty list uchar int vertex_indices\n"
                 "end_header\n0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
    (tmp_path / "a.ply").write_text(ascii_ply)
    for a, b in zip(io_ply.read_ply(str(tmp_path / "a.ply")),
                    jax_ply.read_ply(str(tmp_path / "a.ply"))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("masked", [False, True], ids=["native", "numpy_masked"])
def test_marching_tets_matches_jax(masked):
    vol = _sphere_tsdf()
    mask = (np.abs(vol) < 0.9) if masked else None
    kw = dict(origin=np.array([0.5, -1.0, 2.0]), voxel_size=0.04, mask=mask)
    v, f = marching_cubes.tsdf_to_mesh(vol, **kw)
    jv, jf = jax_mc.tsdf_to_mesh(vol, **kw)
    assert len(f) > 100
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    nv, nf = marching_cubes.marching_tetrahedra(vol, level=0.1)
    jnv, jnf = jax_mc.marching_tetrahedra(vol, level=0.1)
    np.testing.assert_array_equal(nv, jnv)
    np.testing.assert_array_equal(nf, jnf)


def test_scene_assembler_matches_jax(tmp_path):
    port = SceneAssembler(voxel_size=0.08, save_dir=str(tmp_path / "p"))
    ref = JaxAssembler(voxel_size=0.08, save_dir=str(tmp_path / "j"))
    steps = [("s0", _sphere_tsdf(12, 4, 1), np.array([0.0, 0.0, 0.0])),
             ("s0", _sphere_tsdf(12, 4, 2), np.array([0.32, -0.16, 0.0])),
             ("s1", _sphere_tsdf(12, 3, 3), np.array([1.0, 1.0, 1.0])),
             ("s0", _sphere_tsdf(12, 5, 4), np.array([-0.4, 0.0, 0.24]))]
    for scene, tsdf, origin in steps:
        occ = np.abs(tsdf) < 0.5 if scene == "s1" else None
        assert port.update(scene, tsdf, origin, occ) == ref.update(scene, tsdf, origin, occ)
    for s in ("s0", "s1"):
        np.testing.assert_array_equal(port.scenes[s].tsdf, ref.scenes[s].tsdf)
        np.testing.assert_array_equal(port.scenes[s].origin_world, ref.scenes[s].origin_world)
    for p, j in zip(port.save_all(), ref.save_all()):
        assert osp.basename(p) == osp.basename(j)
        assert open(p, "rb").read() == open(j, "rb").read()


def test_depth_and_fscore_metrics_match_jax():
    rs = np.random.RandomState(0)
    gt = rs.uniform(0.5, 4.0, (24, 32)).astype(np.float32)
    gt[:3] = 0
    pred = (gt * rs.uniform(0.8, 1.25, gt.shape)).astype(np.float32)
    pred[5:8] = 0
    assert eval_depth(pred, gt) == jax_eval_depth(pred, gt)
    empty = eval_depth(np.zeros_like(gt), gt)
    assert np.isnan(empty["AbsRel"]) and empty["complete"] == 0.0
    assert set(empty) == set(jax_eval_depth(np.zeros_like(gt), gt))
    a = rs.rand(400, 3)
    b = a + rs.normal(0, 0.03, a.shape)
    for kw in (dict(), dict(threshold=0.02, down_sample=None)):
        assert eval_fscore_points(a, b, **kw) == jax_eval_fscore(a, b, **kw)


def test_render_depth_matches_jax(monkeypatch):
    v, f = marching_cubes.tsdf_to_mesh(_sphere_tsdf(16, 5), voxel_size=2.0)
    pv = np.concatenate([v[:, :2], v[:, 2:] + 5.0], 1).astype(np.float32)
    d = native.render_depth(pv, f, 32, 40)
    assert (d > 0).sum() > 100
    np.testing.assert_array_equal(d, jax_native.render_depth(pv, f, 32, 40))
    # the numpy versions, where the C++ build is missing, agree with each other
    monkeypatch.setattr(native, "_native", False)
    monkeypatch.setattr(jax_native, "_native", False)
    small = f[:60]
    np.testing.assert_array_equal(native.render_depth(pv, small, 32, 40),
                                  jax_native.render_depth(pv, small, 32, 40))


def test_scannet_evaluate_matches_jax(tmp_path):
    root = str(tmp_path / "data")
    jax_write_fixture(root, splits=("test",), n_frames=12)
    gt_v, gt_f = io_ply.read_ply(osp.join(root, "scans_test", SCENE, f"{SCENE}_vh_clean_2.ply"))
    rs = np.random.RandomState(0)
    pred = str(tmp_path / "pred.ply")
    io_ply.write_ply(pred, gt_v + rs.normal(0, 0.02, gt_v.shape).astype(np.float32), gt_f)
    outputs = dict(scene_name=[SCENE], mesh_path=[pred])
    port = ScanNetDataset(root, mode="test").evaluate(outputs, metric="depth_mesh")
    ref = JaxScanNetDataset(root, mode="test").evaluate(outputs, metric="depth_mesh")
    assert port == ref
    assert set(port) == {"AbsRel", "AbsDiff", "SqRel", "RMSE", "LogRMSE", "r1", "r2", "r3",
                         "complete", "dist1", "dist2", "prec", "recal", "fscore"}
    assert port["fscore"] > 0.5 and 0 < port["complete"] <= 1


def test_scannet_evaluate_pool_matches_jax(tmp_path):
    """Two scenes are scored in a pool of spawn workers (one scene in the
    calling process): the same numbers as JAX's, and as one scene's."""
    root = str(tmp_path / "data")
    jax_write_fixture(root, splits=("test",), n_frames=12)
    gt_v, gt_f = io_ply.read_ply(osp.join(root, "scans_test", SCENE, f"{SCENE}_vh_clean_2.ply"))
    rs = np.random.RandomState(1)
    pred = str(tmp_path / "pred.ply")
    io_ply.write_ply(pred, gt_v + rs.normal(0, 0.02, gt_v.shape).astype(np.float32), gt_f)
    two = dict(scene_name=[SCENE, SCENE], mesh_path=[pred, pred])
    port = ScanNetDataset(root, mode="test").evaluate(two, metric="depth_mesh", n_proc=2)
    assert port == JaxScanNetDataset(root, mode="test").evaluate(two, metric="depth_mesh")
    one = dict(scene_name=[SCENE], mesh_path=[pred])
    assert port == ScanNetDataset(root, mode="test").evaluate(one, metric="depth_mesh")
