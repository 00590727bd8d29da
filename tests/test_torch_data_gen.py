"""The face data-gen tools and AFLW2000 against their JAX twins.

- ``tools/data_gen_prnet.py --synthetic-bfm`` against JAX's
  ``tools/data_gen/prnet.py`` on the same 300W-LP fixture
  (``datasets/synthetic.py::write_300wlp_fixture``) at 64²: the same file
  names and ``list.txt``, ``uv_kpt_ind.txt`` equal, position maps within
  1e-5 (both rasterise the same float32 vertices with the same z-buffer;
  the crop's transform draws the same seeded perturbation).  The crops are
  not compared: JAX writes JPEG; the port writes PNG and is held to
  ``image_ops.warp_affine`` on the image read back.
- ``AFLW2000Dataset`` with the ``FaceLandmarkCrop`` pipeline against JAX's
  on ``write_aflw2000_fixture``: every item equal (float32 rounding of the
  crop's warp, 1e-4 on [0, 1] pixels) and the NME of the same predictions
  equal to 1e-6.  Without ``tform_mat`` in the results the port takes the
  crops' transforms from its items, where JAX raises ``KeyError``.
- ``data_gen_multipie organize``'s indexes equal to JAX's, and the FAN
  quirk pinned: ``get-lmk`` and ``organize``'s aux-info step raise
  ``TypeError`` at ``FaceAlignment(weights_path=...)`` on both sides.
"""
import argparse
import os
import pickle
import runpy
import sys

import numpy as np
import pytest

from deep3dmap_tpu_torch.datasets.synthetic import (write_300wlp_fixture,
                                                    write_aflw2000_fixture)
from deep3dmap_tpu_torch.tools import data_gen_multipie, data_gen_prnet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 64


def _jax_tool(rel, argv):
    old = sys.argv
    sys.argv = [rel] + argv
    try:
        runpy.run_path(os.path.join(ROOT, rel), run_name="__main__")
    finally:
        sys.argv = old


@pytest.fixture(scope="module")
def prnet_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("prnet")
    write_300wlp_fixture(str(d / "in"), n_images=3, img_size=200, seed=1)
    argv = ["-i", str(d / "in"), "--resolution", str(RES), "--synthetic-bfm"]
    data_gen_prnet.main(argv + ["-o", str(d / "port")])
    _jax_tool("tools/data_gen/prnet.py", argv + ["-o", str(d / "jax")])
    return d


def test_prnet_data_gen_matches_jax(prnet_runs):
    d = prnet_runs
    port, jax_ = sorted(os.listdir(d / "port")), sorted(os.listdir(d / "jax"))
    assert port == jax_ and len(port) == 3 * 2 + 2
    for name in ("list.txt", "uv_kpt_ind.txt"):
        assert (d / "port" / name).read_text() == (d / "jax" / name).read_text()
    for name in port:
        if name.endswith(".npy"):
            a, b = np.load(d / "port" / name), np.load(d / "jax" / name)
            assert a.shape == b.shape == (RES, RES, 3) and np.abs(b).max() > 1
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=name)


def test_prnet_crops_read_back(prnet_runs):
    """The crops are PNG under ``_inp.jpg`` names, the warp of the input at
    the transform the tool drew; ``ThreeHundredWLPDataset`` reads them."""
    from deep3dmap_tpu_torch.datasets.real_files import ThreeHundredWLPDataset, imread_rgb

    d = prnet_runs
    with open(d / "port" / "list.txt") as f:
        names = f.read().split()
    with open(d / "port" / names[0].replace(".jpg", "_inp.jpg"), "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    ds = ThreeHundredWLPDataset(str(d / "port" / "list.txt"), img_prefix=str(d / "port"),
                                resolution=RES, uv_kpt_ind_file=str(d / "port" / "uv_kpt_ind.txt"))
    assert len(ds) == 3 and ds[0]["faceimg"].shape == (RES, RES, 3)
    gp = data_gen_prnet.GeneratePos(RES, RES, synthetic=True, seed=0)
    img = imread_rgb(str(d / "in" / names[0]))
    import scipy.io as sio
    info = sio.loadmat(str(d / "in" / names[0].replace("jpg", "mat")))
    crop, uv = gp.process_arrays(img, info["Pose_Para"].T.astype(np.float32).reshape(-1),
                                 info["Shape_Para"], info["Exp_Para"])
    np.testing.assert_array_equal(uv, np.load(d / "port" / names[0].replace(".jpg", ".npy")))
    np.testing.assert_allclose(ds[0]["faceimg"], np.clip(np.rint(crop * 255), 0, 255) / 255.0,
                               atol=1e-6)


CROP = [dict(type="FaceLandmarkCrop", resolution_inp=64)]


@pytest.fixture(scope="module")
def aflw(tmp_path_factory):
    d = tmp_path_factory.mktemp("aflw")
    return write_aflw2000_fixture(str(d), n_images=3, img_size=160, seed=2), str(d)


def test_aflw2000_items_and_nme_match_jax(aflw):
    from deep3dmap_tpu.datasets.pipelines import Compose as JCompose
    from deep3dmap_tpu.datasets.real_files import AFLW2000Dataset as J
    from deep3dmap_tpu_torch.datasets import DATASETS, build_dataset

    lst, root = aflw
    jds = J(lst, img_prefix=root, pipeline=JCompose(CROP))
    tds = build_dataset(dict(type="AFLW2000Dataset", datapath=lst, img_prefix=root,
                             pipeline=CROP))
    assert "AFLW2000Dataset" in DATASETS and len(tds) == len(jds) == 3
    for i in range(3):
        a, b = tds[i], jds[i]
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], atol=1e-4, rtol=0, err_msg=k)
    rs = np.random.RandomState(3)
    kpt = [rs.uniform(0, 64, (2, 3, 68)).astype(np.float32),
           rs.uniform(0, 64, (1, 3, 68)).astype(np.float32)]
    tforms = [np.stack([jds[0]["tform_mat"], jds[1]["tform_mat"]]), jds[2]["tform_mat"][None]]
    want = jds.evaluate({"kpt": kpt, "tform_mat": tforms})
    got = tds.evaluate({"kpt": kpt, "tform_mat": tforms})
    assert np.isfinite(want["nme"]) and want["nme"] > 0
    np.testing.assert_allclose(got["nme"], want["nme"], rtol=1e-6)
    # tools/test.py collects no tform_mat: the port takes its items' own
    np.testing.assert_allclose(tds.evaluate({"kpt": kpt})["nme"], want["nme"], rtol=1e-6)
    with pytest.raises(KeyError):
        jds.evaluate({"kpt": kpt})
    with pytest.raises(KeyError, match="not supported"):
        tds.evaluate({"kpt": kpt}, metric="auc")


def _multipie_labels(path):
    rs = np.random.RandomState(4)
    lines, uvtex = [], []
    for i in range(40):
        fid, session = rs.randint(1, 6), rs.choice(["01", "02", "03", "04"])
        rec, cam, illum = f"0{rs.randint(1, 4)}", rs.randint(0, 13), rs.choice(["10", "05"])
        name = f"{fid:03d}_{session}_{rec}_{cam:02d}_{illum}.png"
        lines.append(f"imgs/{name} {fid - 1} {cam}")
        uvtex.append(f"uv/{fid:03d}_{session}_{rec}.png")
    lines.append("short line")
    path.write_text("\n".join(lines) + "\n")
    uv = path.parent / "uvtex.txt"
    uv.write_text("\n".join(uvtex[::3] + ["uv/009_01_01.png"]) + "\n")
    return uv


def test_multipie_organize_matches_jax(tmp_path):
    labels = tmp_path / "labels.txt"
    uv = _multipie_labels(labels)
    argv = ["organize", "--labels", str(labels), "--uvtex-list", str(uv)]
    data_gen_multipie.main(argv + ["--out", str(tmp_path / "port")])
    _jax_tool("tools/data_gen/multipie.py", argv + ["--out", str(tmp_path / "jax")])
    for name in ("multipie_idillumexp2poseimgpaths.pkl", "multipie_uvtex2poseimgs.pkl"):
        with open(tmp_path / "port" / name, "rb") as f:
            a = pickle.load(f)
        with open(tmp_path / "jax" / name, "rb") as f:
            b = pickle.load(f)
        assert a == b and len(b) > 0, name
    assert data_gen_multipie.get_expression("02", "03") == "squint"
    assert data_gen_multipie.get_expression("09", "01") == "neutral"
    obj = tmp_path / "m.obj"
    obj.write_text("v 1 2 3\nvt 0 0\nv 4.5 5 6\nf 1 2 3\n")
    np.testing.assert_array_equal(data_gen_multipie.read_obj(str(obj)), [[1, 2, 3], [4.5, 5, 6]])


def test_multipie_fan_quirk_on_both_sides(tmp_path):
    """JAX's tool builds ``FaceAlignment(weights_path=...)``, which takes no
    such argument, in ``get-lmk`` and in ``organize``'s aux-info step; both
    sides raise ``TypeError`` there, and the port says why."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_multipie", os.path.join(ROOT, "tools", "data_gen", "multipie.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    labels = tmp_path / "labels.txt"
    _multipie_labels(labels)
    (tmp_path / "objs.txt").write_text("001_01_01.obj\n")
    import scipy.io as sio
    sio.savemat(str(tmp_path / "shape.mat"), {"keypoints": np.arange(68)[None]})
    get_lmk = dict(list=str(labels), root="", out=str(tmp_path / "lmk"), fan_weights=None)
    organize = dict(labels=str(labels), root="", out=str(tmp_path / "org"), uvtex_list=None,
                    obj_list=str(tmp_path / "objs.txt"), obj_root="",
                    model_shape=str(tmp_path / "shape.mat"), fan_weights=None)
    for cmd, kw in (("cmd_get_lmk", get_lmk), ("cmd_organize", organize)):
        with pytest.raises(TypeError, match="weights_path"):
            getattr(jax_tool, cmd)(argparse.Namespace(**kw))
        with pytest.raises(TypeError, match="no weights_path.*face boxes"):
            getattr(data_gen_multipie, cmd)(argparse.Namespace(**kw))


def test_prnet_data_path_through_the_clis(prnet_runs, aflw, tmp_path):
    """The data-gen's output trains PRNet through ``tools/train.py`` and
    ``tools/test.py`` evaluates it on AFLW2000 given by ``--cfg-options``
    (``prnet_synthetic.py``'s 64² model on the CPU; phase 31 runs
    ``prnet_300wlp.py``'s on the card)."""
    from deep3dmap_tpu_torch.tools import test as test_cli
    from deep3dmap_tpu_torch.tools import train as train_cli

    out, (lst, root) = str(prnet_runs / "port"), aflw
    cfg = os.path.join(ROOT, "configs", "prnet", "prnet_synthetic.py")
    train = ["data.train._delete_=True", "data.train.type=ThreeHundredWLPDataset",
             f"data.train.datapath={out}/list.txt", f"data.train.img_prefix={out}",
             f"data.train.resolution={RES}", f"data.train.uv_kpt_ind_file={out}/uv_kpt_ind.txt",
             f"model.model_cfgs.uv_kpt_ind_file={out}/uv_kpt_ind.txt", "data.samples_per_gpu=3"]
    test = ["data.test._delete_=True", "data.test.type=AFLW2000Dataset",
            f"data.test.datapath={lst}", f"data.test.img_prefix={root}",
            f"data.test.pipeline=[{{'type': 'FaceLandmarkCrop', 'resolution_inp': {RES}}}]"]
    wd = str(tmp_path / "wd")
    runner = train_cli.main([cfg, "--work-dir", wd, "--device", "cpu", "--max-epochs", "1",
                             "--cfg-options", *train])
    assert runner.epoch == 1 and runner.state.step == 1
    res = test_cli.main([cfg, "--work-dir", wd, "--checkpoint", "auto", "--eval", "nme",
                         "--device", "cpu", "--cfg-options", *train, *test])
    assert np.isfinite(res["nme"]) and res["nme"] > 0
