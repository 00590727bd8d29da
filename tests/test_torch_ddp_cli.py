"""Every published family config through ``tools/train.py --launcher pytorch``
at 2 gloo ranks on the CPU (``torch_dist.run_ranks``, one rank group for
the file; each rank calls the CLI's ``main`` as ``torchrun`` would), one
epoch each at the small widths of its one-rank CLI test:
``prnet_300wlp.py`` (then ``tools/test.py --eval nme``),
``imgs2face_multipie.py`` with ``use_sampling=False``, ``gnerf/blender.py``,
``lerf/lerf.py`` (its ray batches alike on every rank, each keeping its
half) and ``gan2shape/celeba.py`` (the instance replicated).  The ranks end
on the same weights, the data-parallel frameworks with a loss group and
Gan2Shape without.  Then a launcher twin, ``deep3dmap_tpu_torch/scripts/
prnet/run_train_prnet.sh`` with ``GPUS=2 DEVICE=cpu``, under ``torchrun``.
"""
import os
import os.path as osp
import subprocess

import cv2
import numpy as np
import pytest
import torch

from deep3dmap_tpu_torch.datasets.gan_faces import SyntheticGanFaceDataset
from deep3dmap_tpu_torch.tools import test as test_cli
from deep3dmap_tpu_torch.datasets.synthetic import (seeded_clip_state_dict,
                                                    seeded_dino_state_dict,
                                                    write_blender_fixture)
from deep3dmap_tpu_torch.utils.torch_import import import_npz_entries
from test_real_configs import _multipie_fixture
from test_torch_face_cli import _300wlp_fixture
from torch_dist import ROOT, run_ranks

CFG = osp.join(ROOT, "configs")
GNERF_SMALL = ["model.model_cfgs.patch_size=16", "model.model_cfgs.inv_size=16",
               "model.model_cfgs.fc_depth=2", "model.model_cfgs.fc_dim=16",
               "model.model_cfgs.N_samples=4", "model.model_cfgs.N_importance=4",
               "model.model_cfgs.ndf=8", "model.model_cfgs.inv_depth=2",
               "workflow=[('train',1)]"]


def _prnet(tmp):
    root = tmp / "300wlp"
    root.mkdir()
    _300wlp_fixture(root)
    kpt = f"{root}/uv_kpt_ind.txt"
    opts = ["--device", "cpu", "--cfg-options",
            f"data.train.datapath={root}/list.txt", f"data.train.img_prefix={root}",
            f"data.train.uv_kpt_ind_file={kpt}", "data.train.resolution=32",
            f"data.test.datapath={root}/list_val.txt", f"data.test.img_prefix={root}",
            f"data.test.uv_kpt_ind_file={kpt}", "data.test.resolution=32",
            "data.samples_per_gpu=2", "model.model_cfgs.resolution=32",
            "model.model_cfgs.base_channels=4", f"model.model_cfgs.uv_kpt_ind_file={kpt}"]
    cfg, wd = osp.join(CFG, "prnet", "prnet_300wlp.py"), str(tmp / "prnet_wd")
    return dict(name="prnet", train=[cfg, "--work-dir", wd, "--max-epochs", "1", *opts],
                test=[cfg, "--work-dir", wd, "--checkpoint", "auto", "--eval", "nme", *opts])


def _imgs2mesh(tmp):
    root = tmp / "multipie"
    root.mkdir()
    _multipie_fixture(root)
    opts = []
    for split in ("train", "test"):
        opts += [f"data.{split}.datadir={root}", f"data.{split}.imgdir={root}/images",
                 f"data.{split}.objroot={root}/objs", f"data.{split}.image_size=64"]
    opts += ["model.model_cfgs.image_size=64", "model.model_cfgs.n_verts=256",
             "model.model_cfgs.use_sampling=False", "data.samples_per_gpu=1"]
    return dict(name="imgs2mesh", train=[
        osp.join(CFG, "pt3d_demos", "imgs2face_multipie.py"), "--work-dir",
        str(tmp / "i2m_wd"), "--max-epochs", "1", "--device", "cpu", "--cfg-options", *opts])


def _gnerf(tmp):
    root = write_blender_fixture(str(tmp / "lego"), splits=(("train", 4), ("val", 2),
                                                            ("test", 2)), img_wh=(32, 32))
    data = [f"data.{s}.data_dir={root}" for s in ("train", "val", "test")]
    data += [f"data.{s}.img_wh=(16,16)" for s in ("train", "val", "test")]
    return dict(name="gnerf", train=[
        osp.join(CFG, "gnerf", "blender.py"), "--work-dir", str(tmp / "gnerf_wd"),
        "--max-epochs", "1", "--device", "cpu", "--cfg-options", *data,
        "model.model_cfgs.img_wh=(16,16)", *GNERF_SMALL])


def _lerf(tmp):
    lego = write_blender_fixture(str(tmp / "lerf_lego"), splits=(("train", 3), ("test", 1)),
                                 img_wh=(32, 32))
    clip, dino = str(tmp / "clip.npz"), str(tmp / "dino.npz")
    np.savez(clip, **import_npz_entries("clip", seeded_clip_state_dict(
        0, width=64, layers=1, patch=8, image=32, text_width=32, text_layers=1, embed=64,
        vocab=64, ctx=8)))
    np.savez(dino, **import_npz_entries("dino", seeded_dino_state_dict(
        0, dim=192, depth=2, patch=8, grid=4)))
    opts = [f"data.train.image_dataset.data_dir={lego}",
            "data.train.image_dataset.img_wh=(32,32)", "data.train.rays_per_batch=64",
            "data.train.n_batches=2", "data.train.clip_n_dims=64",
            "data.train.dino_n_dims=192", f"data.train.clip_npz={clip}",
            f"data.train.dino_npz={dino}", "data.train.tile_size_range=(0.25,0.5)",
            "data.train.tile_size_res=2", "data.train.dino_layer=1",
            "model.model_cfgs.clip_n_dims=64", "model.model_cfgs.dino_n_dims=192",
            f"model.model_cfgs.clip_weights={clip}", "model.model_cfgs.N_proposal=16",
            "model.model_cfgs.N_importance=8", "model.model_cfgs.rgb_grid_levels=4",
            "model.model_cfgs.rgb_grid_log2=10", "model.model_cfgs.rgb_grid_end=64",
            "model.model_cfgs.num_lerf_samples=4", "runner.runner_cfgs.max_iters=2"]
    return dict(name="lerf", train=[osp.join(CFG, "lerf", "lerf.py"), "--work-dir",
                                    str(tmp / "lerf_wd"), "--device", "cpu",
                                    "--cfg-options", *opts])


def _gan2shape(tmp):
    root = tmp / "celeba"
    for d in ("images", "latents"):
        (root / d).mkdir(parents=True)
    ds = SyntheticGanFaceDataset(n_samples=3, image_size=32, z_dim=32, device="cpu")
    names = []
    for i in range(3):
        item = ds[i]
        rgb = np.rint((item["input_im"] + 1) / 2 * 255).clip(0, 255).astype(np.uint8)
        cv2.imwrite(str(root / "images" / f"face_{i}.png"), rgb[..., ::-1])
        np.save(root / "latents" / f"face_{i}.npy", item["latent_w"])
        names.append(f"face_{i}.png")
    (root / "list.txt").write_text("\n".join(names[:2]) + "\n")
    (root / "list_val.txt").write_text(names[2] + "\n")
    opts = [f"data.{split}.{k}={root / v}"
            for split, lst in (("train", "list.txt"), ("test", "list_val.txt"))
            for k, v in (("img_list_path", lst), ("img_root", "images"),
                         ("latent_root", "latents"))]
    opts += ["data.train.image_size=32", "data.test.image_size=32",
             "model.model_cfgs.image_size=32", "model.model_cfgs.gan_size=32",
             "model.model_cfgs.z_dim=32", "model.model_cfgs.n_mlp=4", "model.model_cfgs.nf=8",
             "model.model_cfgs.batchsize=2", "model.model_cfgs.gan_ckpt=None",
             "model.model_cfgs.parsing_ckpt=None", "model.model_cfgs.raster_mode=hard",
             "runner.stage_iters=(2,2,2)", "runner.num_stage=1"]
    return dict(name="gan2shape", train=[
        osp.join(CFG, "gan2shape", "celeba.py"), "--work-dir", str(tmp / "g2s_wd"),
        "--max-epochs", "1", "--device", "cpu", "--cfg-options", *opts])


_RUNS = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_cli")
    runs = _RUNS[str(tmp)] = [f(tmp) for f in (_prnet, _imgs2mesh, _gnerf, _lerf,
                                                _gan2shape)]
    return run_ranks(2, "ddp_cli", tmp, timeout=400, runs=runs), tmp


def _same_weights(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name,runner,steps", [
    ("prnet", "EpochBasedRunner", 1), ("imgs2mesh", "StateMachineRunner", 2),
    ("gnerf", "StateMachineRunner", 5), ("lerf", "IterBasedRunner", 2),
    ("gan2shape", "Gan2ShapeRunner", 6)])
def test_published_config_at_two_ranks(runs, name, runner, steps):
    """One epoch (LERF: its 2 iterations) on each rank.  The data-parallel
    frameworks take their share of the samples with a loss group: PRNet's
    4 faces at 2 a batch are one step a rank, imgs2mesh's 4 tuples at 1 two,
    GNeRF's 4 images at 2 one iteration of state A's 5 sequences.
    Gan2Shape fits the whole instance on each rank without a group: one
    stage of 2 + 2 + 2 steps.  The ranks end on the same weights."""
    ranks, _ = runs
    a, b = (r[name] for r in ranks)
    assert a["type"] == b["type"] == runner
    assert a["mesh"] == {"data": 2}
    assert a["grouped"] == b["grouped"] == (name != "gan2shape")
    assert a["step"] == b["step"] == steps, (a["step"], b["step"])
    _same_weights(a["heads"], b["heads"])


def test_prnet_test_cli_at_two_ranks(runs):
    """Its test split's batch of 2 splits over the ranks, the outputs are
    gathered back in order, and rank 0's NME is one rank's (1e-5)."""
    ranks, _ = runs
    res = ranks[0]["prnet"]["test"]
    assert set(res) == {"nme"} and np.isfinite(res["nme"])
    assert ranks[1]["prnet"]["test"] is None
    argv = _prnet_test_argv(runs)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = test_cli.main(argv)
    finally:
        torch.set_num_threads(threads)
    assert one["nme"] == pytest.approx(res["nme"], rel=1e-5)


def _prnet_test_argv(runs):
    _, tmp = runs
    return next(r for r in _RUNS[str(tmp)] if r["name"] == "prnet")["test"]


def test_launcher_twin_runs_two_ranks(tmp_path):
    script = osp.join(ROOT, "deep3dmap_tpu_torch", "scripts", "prnet", "run_train_prnet.sh")
    wd = tmp_path / "wd"
    env = dict(os.environ, GPUS="2", DEVICE="cpu", OMP_NUM_THREADS="1")
    r = subprocess.run(["bash", script, osp.join(CFG, "prnet", "prnet_synthetic.py"),
                        "--work-dir", str(wd), "--max-epochs", "1", "--cfg-options",
                        "data.train.n_samples=8", "model.model_cfgs.base_channels=4"],
                       cwd=str(tmp_path), env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    log = (wd / "train.log").read_text()
    assert "rank=0/2" in log and "mesh={'data': 2}" in log
    assert sorted(p.name for p in (wd / "checkpoints").iterdir()) == ["ckpt_1", "latest"]
