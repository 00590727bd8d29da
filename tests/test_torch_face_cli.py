"""The face workloads through the port's CLIs on the CPU, at small sizes.

- PRNet: ``configs/prnet/prnet_synthetic.py`` as published trains its 2
  epochs (``EpochBasedRunner``, the ``step`` lr policy) and ``tools/test.py
  --eval nme`` reads its checkpoint; ``configs/prnet/prnet_300wlp.py`` on a
  300W-LP-layout fixture (``cv2``-written ``*_inp.jpg`` crops, ``.npy`` UV
  maps, ``list.txt``/``list_val.txt``, ``uv_kpt_ind.txt``) at R 32, base 4.
- imgs2mesh: ``configs/pt3d_demos/imgs2face_synthetic.py`` as published
  trains its 3 epochs through the state switch (``StateMachineRunner``,
  logged), and ``tools/test.py`` runs ``forward_test`` from the checkpoint;
  ``imgs2face_multipie.py`` on ``tests/test_real_configs.py``'s MultiPIE
  fixture at 64² with ``use_sampling=False`` and ``state_steps=[0,1]``, and
  as published (``use_sampling=True``) it stops at its first step with the
  reference's ``KeyError: 'uvtex'``.
- A JAX PRNet ``EpochBasedRunner`` checkpoint (orbax, after an epoch of
  Adam under the step schedule) loads into the port's runner (params, Adam
  moments and the schedule's count exactly) and resumes through the CLI.
  (A JAX ``StateMachineRunner`` checkpoint: ``tests/test_torch_state_machine_runner.py``.)
- Without ``--device cpu`` both CLIs raise on a machine without a GPU.
"""
import logging
import os
import os.path as osp

import cv2
import numpy as np
import pytest
import torch

import jax

from deep3dmap_tpu.datasets.builder import NumpyLoader as JLoader
from deep3dmap_tpu.datasets.face_uv import SyntheticFaceUVDataset as JDataset
from deep3dmap_tpu.models.frameworks.prnet import FaceImg2UV as JFaceImg2UV
from deep3dmap_tpu.parallel import make_mesh
from deep3dmap_tpu.runners.checkpoint import load_checkpoint_raw as jax_load_raw
from deep3dmap_tpu.runners.checkpoint import save_checkpoint as jax_save_checkpoint
from deep3dmap_tpu.runners.epoch_based_runner import EpochBasedRunner as JRunner
from deep3dmap_tpu.utils.config import Config as JaxConfig
from deep3dmap_tpu_torch.models.frameworks import imgs2mesh as TI
from deep3dmap_tpu_torch.models.frameworks.prnet import uv_kpt_ind_from_bfm
from deep3dmap_tpu_torch.runners.checkpoint import latest_checkpoint, load_meta, save_checkpoint
from deep3dmap_tpu_torch.tools import test as test_cli
from deep3dmap_tpu_torch.tools import train as train_cli
from deep3dmap_tpu_torch.utils.from_flax import (load_jax_checkpoint, to_flax_adam_state,
                                                 to_flax_params)
from test_real_configs import _multipie_fixture

torch.set_num_threads(2)
ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
PRNET_SYN = osp.join(ROOT, "configs", "prnet", "prnet_synthetic.py")
PRNET_300W = osp.join(ROOT, "configs", "prnet", "prnet_300wlp.py")
I2F_SYN = osp.join(ROOT, "configs", "pt3d_demos", "imgs2face_synthetic.py")
I2F_MPIE = osp.join(ROOT, "configs", "pt3d_demos", "imgs2face_multipie.py")


@pytest.fixture
def messages():
    """The port's log messages while the test runs (its logger does not
    propagate, and its file handler belongs to the process's first run)."""
    got = []
    handler = logging.Handler()
    handler.emit = lambda record: got.append(record.getMessage())
    logger = logging.getLogger("deep3dmap_tpu_torch")
    logger.addHandler(handler)
    yield got
    logger.removeHandler(handler)


def test_prnet_synthetic_config_trains_and_tests(tmp_path, messages):
    wd = str(tmp_path / "wd")
    runner = train_cli.main([PRNET_SYN, "--work-dir", wd, "--device", "cpu"])
    assert type(runner).__name__ == "EpochBasedRunner"
    assert (runner.epoch, runner.state.step) == (2, 8)
    assert sorted(os.listdir(osp.join(wd, "checkpoints"))) == ["ckpt_4", "ckpt_8", "latest"]
    assert any("loss_kpt" in m and "loss_uv" in m for m in messages)
    res = test_cli.main([PRNET_SYN, "--work-dir", wd, "--checkpoint", "auto", "--eval", "nme",
                         "--device", "cpu"])
    assert set(res) == {"nme"} and np.isfinite(res["nme"]) and res["nme"] > 0


def _300wlp_fixture(root, n=6, s=40):
    rs = np.random.RandomState(0)
    yy, xx = np.meshgrid(np.arange(float(s)), np.arange(float(s)), indexing="ij")
    names = []
    for i in range(n):
        cv2.imwrite(str(root / f"f{i}_inp.jpg"), rs.randint(0, 256, (s, s, 3), np.uint8))
        uv = np.stack([xx, yy, 10 + 4 * np.cos(yy / 5 + i)], -1) + rs.rand(s, s, 3)
        np.save(root / f"f{i}.npy", uv.astype(np.float32))
        names.append(f"f{i}.jpg")
    (root / "list.txt").write_text("\n".join(names[:4]) + "\n")
    (root / "list_val.txt").write_text("\n".join(names[4:]) + "\n")
    np.savetxt(root / "uv_kpt_ind.txt", uv_kpt_ind_from_bfm(None, 32))


def test_prnet_300wlp_config_on_its_layout(tmp_path):
    root = tmp_path / "300wlp"
    root.mkdir()
    _300wlp_fixture(root)
    kpt = f"{root}/uv_kpt_ind.txt"
    opts = ["--cfg-options",
            f"data.train.datapath={root}/list.txt", f"data.train.img_prefix={root}",
            f"data.train.uv_kpt_ind_file={kpt}", "data.train.resolution=32",
            f"data.test.datapath={root}/list_val.txt", f"data.test.img_prefix={root}",
            f"data.test.uv_kpt_ind_file={kpt}", "data.test.resolution=32",
            "data.samples_per_gpu=2", "model.model_cfgs.resolution=32",
            "model.model_cfgs.base_channels=4", f"model.model_cfgs.uv_kpt_ind_file={kpt}"]
    wd = str(tmp_path / "wd")
    runner = train_cli.main([PRNET_300W, "--work-dir", wd, "--max-epochs", "1",
                             "--device", "cpu", *opts])
    assert (runner.epoch, runner.state.step) == (1, 2)
    assert runner.current_lr() == pytest.approx(1e-4)
    np.testing.assert_array_equal(runner.framework.uv_kpt_ind, np.loadtxt(kpt).astype(np.int32))
    res = test_cli.main([PRNET_300W, "--work-dir", wd, "--checkpoint", "auto", "--eval",
                         "nme", "--device", "cpu", *opts])
    assert np.isfinite(res["nme"])


def test_imgs2face_synthetic_config_switches_state(tmp_path, monkeypatch, messages):
    wd = str(tmp_path / "wd")
    runner = train_cli.main([I2F_SYN, "--work-dir", wd, "--device", "cpu"])
    assert type(runner).__name__ == "StateMachineRunner"
    assert (runner.epoch, runner.state.step, runner.cur_state) == (3, 12, "sup_unsup")
    log = "\n".join(messages)
    assert "state switch: sup -> sup_unsup" in messages and "pts_consistent_loss" in log
    assert latest_checkpoint(wd).endswith("ckpt_12")
    seen = []
    orig = TI.Imgs2Mesh.forward_test

    def spy(self, net, state, batch):
        out, state = orig(self, net, state, batch)
        seen.append((torch.equal(net.fc2.weight, runner.state.net.fc2.weight),
                     len(out["outpts_list"]), tuple(out["outpose_list"][0].shape)))
        return out, state
    monkeypatch.setattr(TI.Imgs2Mesh, "forward_test", spy)
    assert test_cli.main([I2F_SYN, "--work-dir", wd, "--device", "cpu"]) is None
    assert seen == [(True, 2, (2, 7))]


@pytest.fixture(scope="module")
def multipie(tmp_path_factory):
    root = tmp_path_factory.mktemp("multipie")
    _multipie_fixture(root)
    return root


def _multipie_opts(root, *extra):
    opts = []
    for split in ("train", "test"):
        opts += [f"data.{split}.datadir={root}", f"data.{split}.imgdir={root}/images",
                 f"data.{split}.objroot={root}/objs", f"data.{split}.image_size=64"]
    return ["--cfg-options", *opts, "model.model_cfgs.image_size=64",
            "model.model_cfgs.n_verts=256", *extra]


def test_imgs2face_multipie_config_through_the_clis(multipie, tmp_path, messages):
    wd = str(tmp_path / "wd")
    opts = _multipie_opts(multipie, "model.model_cfgs.use_sampling=False",
                          "runner.state_steps=[0,1]")
    runner = train_cli.main([I2F_MPIE, "--work-dir", wd, "--max-epochs", "2",
                             "--device", "cpu", *opts])
    assert (runner.epoch, runner.state.step, runner.cur_state) == (2, 2, "sup_unsup")
    assert runner.framework.tuplesize == 3 and "state switch: sup -> sup_unsup" in messages
    assert test_cli.main([I2F_MPIE, "--work-dir", wd, "--device", "cpu", *opts]) is None

    with pytest.raises(KeyError, match="uvtex"):
        train_cli.main([I2F_MPIE, "--work-dir", str(tmp_path / "quirk"), "--max-epochs", "1",
                        "--device", "cpu", *_multipie_opts(multipie)])


def test_jax_prnet_checkpoint_resumes_in_the_port(tmp_path):
    cfg = JaxConfig.fromfile(PRNET_SYN)
    data = {k: v for k, v in cfg.data["train"].items() if k != "type"}
    loader = JLoader(JDataset(**data), batch_size=cfg.data["samples_per_gpu"], shuffle=True)
    jr = JRunner(JFaceImg2UV(cfg.model["model_cfgs"]), work_dir=str(tmp_path / "jax"),
                 mesh=make_mesh(devices=jax.devices()[:1]),
                 runner_cfgs=dict(cfg.runner["runner_cfgs"]))
    jr.setup(next(iter(loader)), optimizer=cfg.runner["runner_cfgs"]["optimizer"],
             lr_config=cfg.lr_config, iters_per_epoch=len(loader))
    jr.run([loader], [("train", 1)], max_epochs=1)
    path = jax_save_checkpoint(str(tmp_path / "jax"), jr.state, meta=dict(epoch=1, iter=4))
    raw = jax_load_raw(path)

    wd = str(tmp_path / "port")
    runner = train_cli.main([PRNET_SYN, "--work-dir", wd, "--max-epochs", "0", "--device", "cpu"])
    runner.state = load_jax_checkpoint(raw, runner.state)
    assert runner.state.step == 4 and runner.state.optimizer.count == 4
    net = runner.state.net
    for a, b in zip(jax.tree_util.tree_leaves(to_flax_params(net)),
                    jax.tree_util.tree_leaves(raw["params"]["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))
    adam = to_flax_adam_state(net, runner.state.optimizer.adam)
    jadam = jr.state.opt_state[0]
    assert adam["count"] == int(jadam.count) == 4
    for k in ("mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves(adam[k]),
                        jax.tree_util.tree_leaves(getattr(jadam, k)["params"])):
            np.testing.assert_array_equal(a, np.asarray(b))

    save_checkpoint(wd, runner.state, meta=load_meta(path))
    resumed = train_cli.main([PRNET_SYN, "--work-dir", wd, "--resume-from", "auto",
                              "--device", "cpu"])
    assert (resumed.epoch, resumed.state.step) == (2, 8)


def test_face_clis_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default does not raise here")
    for cfg in (PRNET_SYN, I2F_SYN):
        for cli in (train_cli, test_cli):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                cli.main([cfg])
