"""The port's config system and registries against the JAX package's.

``Config.fromfile`` of the repo's NeuralRecon configs and of
``configs/gan2shape/celeba.py`` (which inherits through ``_base_`` and
drops keys with ``_delete_``) gives JAX's ``to_dict()``, text and ``dump``;
``DictAction`` parses ``--cfg-options`` as JAX does; the registries build
the frameworks, datasets, hooks and runners by name; an unknown lr policy,
an lr policy the port has not ported and a missing ``_base_`` raise.  All
comparisons are exact.
"""
import argparse
import glob
import os.path as osp

import jax.numpy as jnp
import pytest

from deep3dmap_tpu.runners.optim import build_lr_schedule as jax_build_lr_schedule
from deep3dmap_tpu.utils.config import Config as JaxConfig
from deep3dmap_tpu.utils.config import DictAction as JaxDictAction

from deep3dmap_tpu_torch.datasets.builder import DATASETS, build_dataset
from deep3dmap_tpu_torch.models.builder import RECONSTRUCTORS, build_reconstruction
from deep3dmap_tpu_torch.runners.builder import RUNNERS, build_runner
from deep3dmap_tpu_torch.runners.hooks import (CheckpointHook, IterTimerHook,
                                               TextLoggerHook, build_hook)
from deep3dmap_tpu_torch.runners.optim import build_lr_schedule
from deep3dmap_tpu_torch.utils.config import Config, DictAction

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIGS = sorted(glob.glob(osp.join(ROOT, "configs", "neural_recon", "*.py"))) + [
    osp.join(ROOT, "configs", "gan2shape", "celeba.py")]


@pytest.mark.parametrize("path", CONFIGS, ids=[osp.relpath(p, ROOT) for p in CONFIGS])
def test_fromfile_matches_jax(path):
    port, ref = Config.fromfile(path), JaxConfig.fromfile(path)
    assert port.to_dict() == ref.to_dict()
    assert port.text == ref.text
    assert port.dump() == ref.dump()
    opts = {"data.samples_per_gpu": 3, "work_dir": "elsewhere"}
    port.merge_from_dict(opts)
    ref.merge_from_dict(opts)
    assert port.to_dict() == ref.to_dict()


def _parse(action, argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg-options", nargs="+", action=action)
    return ap.parse_args(argv).cfg_options


@pytest.mark.parametrize("argv", [
    ["model.lr=0.01", "a.flag=True", "a.off=false", "n=None", "x=hello"],
    ["vals=1,2,3", "shape=(16,16)", "names=a,b", "d={'k': [1, 2]}", "e="],
], ids=["scalars", "sequences"])
def test_dict_action_parses_as_jax(argv):
    assert _parse(DictAction, ["--cfg-options", *argv]) == \
        _parse(JaxDictAction, ["--cfg-options", *argv])


def test_dict_action_rejects_a_pair_without_equals():
    for action in (DictAction, JaxDictAction):
        with pytest.raises(ValueError, match="KEY=VALUE"):
            _parse(action, ["--cfg-options", "bad_format"])


def test_base_and_delete(tmp_path):
    (tmp_path / "base.py").write_text(
        "a = dict(x=1, y=dict(p=2, q=3))\nb = [1, 2]\nkeep = 'base'\n")
    (tmp_path / "child.py").write_text(
        "_base_ = './base.py'\na = dict(y=dict(_delete_=True, r=4), z=5)\nb = [3]\n")
    child = str(tmp_path / "child.py")
    port, ref = Config.fromfile(child), JaxConfig.fromfile(child)
    assert port.to_dict() == ref.to_dict() == dict(
        a=dict(x=1, y=dict(r=4), z=5), b=[3], keep="base")
    assert port.a.y.r == 4 and "p" not in port.a.y
    assert Config.fromstring("c = dict(d=1)\n").to_dict() == \
        JaxConfig.fromstring("c = dict(d=1)\n").to_dict()


def test_missing_base_raises_naming_the_file(tmp_path):
    (tmp_path / "orphan.py").write_text("_base_ = './nowhere.py'\nx = 1\n")
    for cls in (Config, JaxConfig):
        with pytest.raises(FileNotFoundError, match="nowhere.py"):
            cls.fromfile(str(tmp_path / "orphan.py"))


@pytest.mark.parametrize("kw", [
    dict(step=[2, 4], gamma=0.5), dict(step=3, gamma=0.1),
    dict(step=[1, 2, 3], gamma=0.1, min_lr=2e-5), dict(step=[], gamma=0.5)],
    ids=["list", "period", "min_lr", "no_bounds"])
@pytest.mark.parametrize("by_epoch", [True, False])
def test_step_schedule_matches_jax(kw, by_epoch):
    port = build_lr_schedule("step", 1e-3, 20, iters_per_epoch=2, by_epoch=by_epoch, **kw)
    ref = jax_build_lr_schedule("step", 1e-3, 20, iters_per_epoch=2, by_epoch=by_epoch, **kw)
    # optax's step count is an int32 array
    assert [port(k) for k in range(21)] == [float(ref(jnp.int32(k))) for k in range(21)]


def test_lr_policies_raise():
    with pytest.raises(ValueError, match="Unknown lr policy"):
        build_lr_schedule("bogus", 1e-3, 10)
    with pytest.raises(ValueError, match="Unknown lr policy"):
        jax_build_lr_schedule("bogus", 1e-3, 10)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_lr_schedule("cosine", 1e-3, 10)


def test_registries_build_by_name(tmp_path):
    cfg = Config.fromfile(osp.join(ROOT, "configs", "neural_recon", "scannet_synthetic.py"))
    fw = build_reconstruction(cfg.model, device="cpu")
    assert type(fw).__name__ == "NeuralRecon" and fw.device.type == "cpu"
    # celeba's model as published: the checkpoint files are read at init and
    # at the first parse_mask, not when the framework is built
    g2s = Config.fromfile(osp.join(ROOT, "configs", "gan2shape", "celeba.py"))
    fw2 = build_reconstruction(g2s.model, device="cpu")
    assert type(fw2).__name__ == "Gan2Shape" and fw2.image_size == 128
    assert fw2.use_mask and fw2.parsing_ckpt == "checkpoints/bisenet_faceparse.npz"
    assert {"NeuralRecon", "Gan2Shape"} <= set(RECONSTRUCTORS.module_dict)

    ds = build_dataset(dict(type="SyntheticScanNetDataset", n_samples=2, n_views=3,
                            img_size=(32, 32), n_vox=16), default_args=dict(device="cpu"))
    assert len(ds) == 2 and "ScanNetDataset" in DATASETS.module_dict
    assert {"CelebaDataset", "SyntheticGanFaceDataset"} <= set(DATASETS.module_dict)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_dataset(dict(type="RepeatDataset", dataset=dict(type="X"), times=2))

    hooks = [build_hook(dict(type=t)) for t in
             ("IterTimerHook", "TextLoggerHook", "CheckpointHook")]
    assert [type(h) for h in hooks] == [IterTimerHook, TextLoggerHook, CheckpointHook]
    runner = build_runner(dict(type="EpochBasedRunner"), default_args=dict(
        framework=fw, work_dir=str(tmp_path), runner_cfgs=dict(max_epochs=2)))
    assert type(runner).__name__ == "EpochBasedRunner" and runner.max_epochs == 2
    g2s_runner = build_runner(dict(g2s.runner), default_args=dict(
        framework=fw2, work_dir=str(tmp_path), runner_cfgs=dict(max_epochs=4)))
    assert type(g2s_runner).__name__ == "Gan2ShapeRunner" and g2s_runner.max_epochs == 4
    assert g2s_runner.stage_iters == dict(step1=600, step2=600, step3=400)
    assert {"EpochBasedRunner", "Gan2ShapeRunner"} <= set(RUNNERS.module_dict)
