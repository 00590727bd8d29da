"""The port's rank mesh and batch placement (``deep3dmap_tpu_torch/parallel/
mesh.py``) against JAX's ``parallel/mesh.py``; the port's ranks are 4 gloo
processes (``torch_dist.run_ranks``, started once for the file), JAX's side
the conftest's 8-device CPU mesh.

- ``MeshSpec``'s shape rules (None, a ``-1`` wildcard, too many ranks)
  against JAX's meshes over 8 devices; without a process group the mesh
  is one rank with no groups;
- ``shard_batch``: the entries JAX drops (not all numeric), float64 as
  float32, and on 4 ranks each rank's slice of a global batch against the
  shard JAX puts on the device at the rank's place in a (4,) and a (2, 2)
  mesh (scalars and leading dims that do not divide replicated);
- ``get_dist_info``, ``master_only``, ``replicate`` and ``init_dist`` (a
  no-op at one process);
- ``tsdf_fuse_frames_sharded`` over 4 ranks (bit-equal to the unsharded
  fusion, JAX's sharded fusion to 1e-6) and ``volume_sharding``;
- ``deep3dmap_tpu_torch.tools.benchmark_scaling`` at 1 and 2 ranks on the
  dense model: ``equivalent`` (JAX's rule) and one loss all-reduce and one
  gradient bucket a step;
- ``tools/train.py --launcher pytorch`` under torchrun at 2 ranks.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JaxMesh

from deep3dmap_tpu.core.tsdf.fusion import TSDFParams as JaxTSDFParams
from deep3dmap_tpu.parallel import make_mesh as jax_make_mesh
from deep3dmap_tpu.parallel import shard_batch as jax_shard_batch
from deep3dmap_tpu.parallel import tsdf_fuse_frames_sharded as jax_fuse_sharded
from deep3dmap_tpu.parallel import volume_sharding as jax_volume_sharding
from deep3dmap_tpu_torch.core.tsdf.fusion import TSDFParams, tsdf_fuse_frames
from deep3dmap_tpu_torch.parallel import (MeshSpec, data_spec, get_dist_info, init_dist,
                                          make_mesh, master_only, shard_batch)
from torch_dist import ROOT, run_ranks, save_inputs

SHAPES = [(("data",), None), (("data", "model"), None), (("data", "model"), (-1, 2)),
          (("data", "model"), (4, 2)), (("data", "model"), (2, -1)), (("data",), (3,))]


def _batch():
    rs = np.random.RandomState(0)
    return {"imgs": rs.randn(8, 2, 3),                    # float64 -> float32
            "ids": np.arange(8),
            "n": np.float32(3.0),                          # replicated
            "odd": rs.randn(3, 2).astype(np.float32),      # 3 rows: replicated
            "lst": [rs.randn(8, 2).astype(np.float32), np.arange(8.0, dtype=np.float32)],
            "scene": "scene0000_00",                       # dropped
            "names": ["a", "b"],                           # dropped
            "mixed": [np.zeros(8, np.float32), "x"]}       # dropped


def _frames():
    """Three depth frames of a tilted plane seen from small offsets, and a
    (16, 6, 5) volume at 0.1 m (an X that divides over 4 ranks)."""
    rs = np.random.RandomState(1)
    yy, xx = np.mgrid[0:24, 0:32].astype(np.float32)
    depth = np.stack([1.2 + 0.01 * xx + 0.005 * yy + 0.05 * k for k in range(3)])
    K = np.tile(np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]], np.float32), (3, 1, 1))
    pose = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    pose[:, :3, 3] = rs.randn(3, 3).astype(np.float32) * 0.05
    return dict(depth=depth.astype(np.float32), K=K, pose=pose,
                origin=np.array([-0.8, -0.3, 0.8], np.float32),
                params=dict(dim=(16, 6, 5), voxel_size=0.1))


@pytest.mark.parametrize("axes,shape", SHAPES)
def test_mesh_shape_rules_against_jax(axes, shape):
    want = jax_make_mesh(axes, shape)
    got = MeshSpec(axes, shape).resolve(8)
    assert dict(zip(axes, got)) == dict(want.shape)


def test_mesh_errors_and_one_rank():
    with pytest.raises(ValueError, match="needs 16 devices"):
        jax_make_mesh(("data",), (16,))
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        MeshSpec(("data",), (16,)).resolve(8)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh(("data",), (2,), device="cpu")
    mesh = make_mesh(("data", "model"), device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.device_mesh is None
    assert mesh.group("data") is None and mesh.coordinate("model") == 0
    assert data_spec(mesh) == ("data",) and data_spec(mesh, "x") == ()
    assert get_dist_info() == (0, 1)
    assert master_only(lambda: 7)() == 7
    init_dist(device="cpu")          # WORLD_SIZE unset: one process, no group
    assert not torch.distributed.is_initialized()


def test_shard_batch_drops_what_jax_drops():
    batch = _batch()
    want = jax_shard_batch(batch, jax_make_mesh(("data",), (1,)))
    got = shard_batch(batch, make_mesh(device="cpu"))
    assert sorted(got) == sorted(want) == ["ids", "imgs", "lst", "n", "odd"]
    assert got["imgs"].dtype == torch.float32 and got["imgs"].device.type == "cpu"
    np.testing.assert_array_equal(got["imgs"].numpy(), np.asarray(want["imgs"]))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    return run_ranks(4, "mesh", tmp, inputs=save_inputs(
        tmp, "mesh_in.pt", dict(batch=_batch(), frames=_frames())))


def test_dist_info_master_only_replicate(ranks):
    for r, out in enumerate(ranks):
        assert out["dist_info"] == (r, 4)
        assert out["master_only"] == (10 if r == 0 else None)
        t, w = out["replicated"]
        assert np.all(t == 0.0) and np.all(w == 0.0)


@pytest.mark.parametrize("name,axes,shape", [("flat", ("data",), None),
                                             ("grid", ("data", "model"), (2, 2)),
                                             ("wild", ("data", "model"), (-1, 2))])
def test_shard_batch_slices_against_jax(ranks, name, axes, shape):
    batch = _batch()
    jmesh = JaxMesh(np.array(jax.devices()[:4]).reshape(
        [s if s != -1 else 2 for s in (shape or (4,))]), axes)
    want = jax_shard_batch(batch, jmesh)
    for r, out in enumerate(ranks):
        got = out[name]
        assert got["shape"] == dict(jmesh.shape)
        pos = np.argwhere(np.array(jmesh.device_ids) == jax.devices()[r].id)[0]
        assert got["coords"] == {a: int(p) for a, p in zip(axes, pos)}
        assert got["group_sizes"] == dict(jmesh.shape)
        dev = jax.devices()[r]
        for k, v in want.items():
            leaves = v if isinstance(v, list) else [v]
            mine = got["batch"][k] if isinstance(v, list) else [got["batch"][k]]
            for a, b in zip(leaves, mine):
                shard = next(s.data for s in a.addressable_shards if s.device == dev)
                np.testing.assert_array_equal(b, np.asarray(shard), err_msg=f"{name} {k}")


def test_tsdf_fuse_frames_sharded_against_jax(ranks):
    """Each rank's slab, put together, equals the unsharded fusion bit for bit
    (the slab integrates with the whole volume's voxel coordinates) and
    JAX's sharded fusion over a 4-device ``x`` axis to 1e-6."""
    fr = _frames()
    args = [fr[k] for k in ("depth", "K", "pose", "origin")]
    got = [np.concatenate([r["tsdf_slab"][i] for r in ranks]) for i in (0, 1)]
    whole = tsdf_fuse_frames(*map(torch.tensor, args), TSDFParams(**fr["params"]))
    for g, w in zip(got, whole):
        np.testing.assert_array_equal(g, w.numpy())
    mesh = JaxMesh(np.array(jax.devices()[:4]), ("x",))
    want = jax_fuse_sharded(*args, JaxTSDFParams(**fr["params"]), mesh, axis="x")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6)
    assert np.any(got[1] > 0) and np.any(got[0] < 1)


@pytest.mark.parametrize("name,axes,shape", [("flat", ("data",), (4,)),
                                             ("grid", ("data", "model"), (2, 2)),
                                             ("model", ("model",), (4,))])
def test_volume_sharding_against_jax(ranks, name, axes, shape):
    jmesh = JaxMesh(np.array(jax.devices()[:4]).reshape(shape), axes)
    want = tuple(jax_volume_sharding(jmesh, "model", "data").spec)
    for out in ranks:
        assert tuple(out["volume_sharding"][name]) == want


def test_scaling_tool_one_and_two_ranks(tmp_path):
    out = tmp_path / "scaling.json"
    r = subprocess.run([sys.executable, "-m", "deep3dmap_tpu_torch.tools.benchmark_scaling",
                        "--devices", "1", "2", "--modes", "dense", "--n-vox", "16",
                        "--img", "32", "--views", "2", "--iters", "1", "--device", "cpu",
                        "--timeout", "200", "--out", str(out)],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    rep = json.loads(r.stdout.strip().splitlines()[-1])
    assert rep == json.loads(out.read_text())
    rows = rep["modes"]["dense"]
    assert [row["devices"] for row in rows] == [1, 2] and rep["all_equivalent"]
    assert rows[1]["first_step_rel_drift_vs_1dev"] < 1e-5
    for row in rows:
        assert row["collectives"] == {"all_reduce": 2} and len(row["losses"]) == 2
        assert row["backend"] == "gloo" and row["route"] == "gloo, CPU"


def test_train_cli_two_ranks(tmp_path):
    """``tools/train.py --launcher pytorch`` under torchrun, 2 gloo ranks: each
    rank's loader takes its half of the epoch, the runner's mesh is
    ``{'data': 2}``, rank 0 logs and alone saves the checkpoint."""
    wd = tmp_path / "wd"
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc_per_node", "2", "-m", "deep3dmap_tpu_torch.tools.train",
                        "configs/neural_recon/scannet_synthetic.py", "--launcher", "pytorch",
                        "--device", "cpu", "--work-dir", str(wd), "--max-epochs", "1",
                        "--cfg-options", "data.train.n_samples=4", "data.train.n_vox=16",
                        "model.model_cfgs.N_VOX=[16,16,16]"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    log = (wd / "train.log").read_text()
    assert "rank=0/2" in log and "mesh={'data': 2}" in log
    assert "Epoch [1][2/2]" in log       # 4 samples over 2 ranks: 2 steps a rank
    assert sorted(p.name for p in (wd / "checkpoints").iterdir()) == ["ckpt_2", "latest"]
