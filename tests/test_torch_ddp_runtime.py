"""The runtime on a mesh, on the CPU: 2 gloo ranks (``torch_dist.run_ranks``,
one rank group for the file) with NeuralRecon's dense config (16³, 2 views
at 64²), each part against the port's one rank in this process (one
thread, as the ranks run).

- Checkpoints of the spatial path hold whole volumes, as JAX's
  ``device_get`` does: a step over ("data", "model") = (1, 2), then
  ``save_checkpoint`` (every rank gathers its X slabs, rank 0 writes).  The
  file's volumes are the ranks' slabs put together; resumed on the mesh
  each rank gets its own slabs back; resumed on one rank the state is
  whole and its next step is within phase 32 (b)'s spatial bounds of the
  mesh's next step (loss 1e-3 relative, whole gradient 1e-4); a one-rank
  checkpoint resumed on the mesh gives each rank its slabs of the whole.
- ``val`` over the ``data`` axis on a global batch of 2: every rank
  reports the global batch's loss, one rank's ``val_fn`` on the whole
  batch to 1e-5 relative.
- ``tools/test.py --launcher pytorch``: every rank streams a scene's
  fragments in order with the recurrent state carried (the fragments
  after the first do not reset it), so each rank's ``forward_test`` calls
  give one rank's outputs, fragment by fragment: bit-equal where each
  batch of one runs whole on every rank, and within 1e-5 of one rank's
  with the global volumes sharded over ("data", "model") = (1, 2) (the
  halo GRU sums its convs in two slabs).  (A batch split over ``data``
  and gathered back: ``tests/test_torch_ddp_cli.py``'s PRNet test.)
"""
import os.path as osp

import numpy as np
import pytest
import torch

from deep3dmap_tpu_torch.models.frameworks.neuralrecon import NeuralRecon
from deep3dmap_tpu_torch.runners.checkpoint import load_checkpoint_raw
from test_torch_neuralrecon_train import CFGS
from torch_dist import (ROOT, record_test_outputs, run_ranks, runner_step, save_inputs,
                        spatial_runner, volumes)
from torch_slice_helpers import two_fragments

CFG = CFGS["dense"][0]
SPATIAL_LOSS_RTOL = 1e-3
SPATIAL_GRAD_RTOL = 1e-4
VAL_RTOL = 1e-5
SPATIAL_OUT_ATOL = 1e-5
TEST_CFG = osp.join(ROOT, "configs", "neural_recon", "scannet_synthetic.py")
TEST_OPTS = ["data.test.type=StreamScanNetDataset", "data.test.n_samples=3",
             "data.test.n_vox=16", "data.test.n_views=2", "model.model_cfgs.N_VOX=[16,16,16]",
             "model.model_cfgs.save_scene=False"]
TEST_RUNS = {"data": TEST_OPTS,
             "grid": TEST_OPTS + ["mesh.axes=('data','model')", "mesh.shape=(1,2)"]}


def _flat(tree):
    if isinstance(tree, dict):
        return np.concatenate([_flat(v) for _, v in sorted(tree.items())])
    return np.ravel(np.asarray(tree, np.float64))


class _OneThread:
    def __enter__(self):
        self.n = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_rt")
    frags = two_fragments(2, 16, seeds=((0,), (1,)))
    pair = two_fragments(2, 16, seeds=((2, 3),))[0]
    with _OneThread():
        one = spatial_runner(CFG, frags[0], str(tmp / "one"), None)
        runner_step(one, frags[0])
        one_ckpt = one.save_checkpoint()
        whole_one = volumes(one)
    argv = [TEST_CFG, "--work-dir", str(tmp / "test_wd"), "--device", "cpu"]
    path = save_inputs(tmp, "ddp_rt_in.pt", dict(
        cfg=CFG, frags=frags, pair=pair, wd=str(tmp / "wd"), wd2=str(tmp / "wd2"),
        one_rank_ckpt=one_ckpt, test_argv=argv, test_runs=TEST_RUNS))
    ranks = run_ranks(2, "ddp_runtime", tmp, timeout=300, inputs=path)
    return dict(ranks=ranks, frags=frags, pair=pair, whole_one=whole_one, tmp=tmp, argv=argv)


def _ok(runs, *parts):
    for r in runs["ranks"]:
        bad = {p: r["errors"][p] for p in parts if p in r["errors"]}
        assert not bad, bad


def test_spatial_checkpoint_holds_whole_volumes(runs):
    _ok(runs, "checkpoint")
    a, b = runs["ranks"]
    assert a["spatial_on"] and b["spatial_on"]
    assert b["saved"] is None and a["saved"]
    saved = load_checkpoint_raw(a["saved"], "cpu")["model_state"]
    assert len(saved) == len(a["slabs"]) == 3
    for v, s0, s1 in zip(saved, a["slabs"], b["slabs"]):
        assert v.shape[1] == v.shape[2] == 2 * s0.shape[1]
        np.testing.assert_array_equal(v.numpy(), np.concatenate([s0, s1], axis=1))


def test_spatial_checkpoint_resumes_on_the_mesh(runs):
    _ok(runs, "checkpoint", "resume_mesh")
    for r in runs["ranks"]:
        for got, want in zip(r["resumed_slabs"], r["slabs"]):
            np.testing.assert_array_equal(got, want)
    a, b = runs["ranks"]
    assert a["resumed_step"]["loss"] == b["resumed_step"]["loss"]


def test_spatial_checkpoint_resumes_on_one_rank(runs, tmp_path):
    _ok(runs, "checkpoint", "resume_mesh")
    a, b = runs["ranks"]
    with _OneThread():
        one = spatial_runner(CFG, runs["frags"][0], str(tmp_path), None)
        assert one.resume(a["saved"])
        for v, s0, s1 in zip(volumes(one), a["slabs"], b["slabs"]):
            np.testing.assert_array_equal(v, np.concatenate([s0, s1], axis=1))
        step = runner_step(one, runs["frags"][1])
    want, got = step, a["resumed_step"]
    assert abs(got["loss"] - want["loss"]) <= SPATIAL_LOSS_RTOL * abs(want["loss"])
    g, w = _flat(got["grads"]), _flat(want["grads"])
    assert np.linalg.norm(g - w) <= SPATIAL_GRAD_RTOL * np.linalg.norm(w)


def test_one_rank_checkpoint_resumes_on_the_mesh(runs):
    _ok(runs, "resume_one")
    for r, rank in enumerate(runs["ranks"]):
        for got, whole in zip(rank["from_one_slabs"], runs["whole_one"]):
            k = whole.shape[1] // 2
            np.testing.assert_array_equal(got, whole[:, r * k:(r + 1) * k])


def test_val_reports_the_global_batch_loss(runs):
    _ok(runs, "val")
    a, b = runs["ranks"]
    assert a["val_loss"] == b["val_loss"] and len(a["val_loss"]) == 1
    with _OneThread():
        fw = NeuralRecon(CFG, device="cpu")
        net, _ = fw.init(0, runs["pair"])
        want = float(fw.val_fn(net, fw.init_state(2), runs["pair"])["log_vars"]["loss"])
    assert abs(a["val_loss"][0] - want) <= VAL_RTOL * abs(want), (a["val_loss"], want)


def test_test_cli_streams_the_scene_in_order(runs):
    _ok(runs, "test")
    with _OneThread():
        want = record_test_outputs(runs["argv"] + ["--cfg-options", *TEST_OPTS])
    assert len(want) == 3
    for name, atol in (("data", 0.0), ("grid", SPATIAL_OUT_ATOL)):
        for rank in runs["ranks"]:
            got = rank["test"][name]
            assert len(got) == len(want), name
            for i, (g, w) in enumerate(zip(got, want)):
                assert g.keys() == w.keys() == {"tsdf", "occ", "origin"}
                for k in w:
                    np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol,
                                               err_msg=f"{name} fragment {i} {k}")
    # the state carries: the fragments after the first see the earlier ones
    assert not np.array_equal(want[1]["occ"], want[0]["occ"])
