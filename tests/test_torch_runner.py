"""The port's runtime around the training step against the JAX package's, on
the CPU: ``EpochBasedRunner`` with its hooks, the ``step`` lr schedule,
checkpoints, ``resume`` and a validation workflow, and a JAX checkpoint
carried into the port (``utils/from_flax.py::load_jax_checkpoint``).

The configuration is ``tools/quality_regression.py``'s (NeuralRecon, dense
24³ pyramid, 5 views at 64x48, clip + Adam, lr halved at epochs 60 and 90;
here the bounds are cut to epochs 1 and 2 so that the schedule moves inside
the run) on the fixture scene that ``write_scannet_fixture`` draws, two
fragments an epoch.  The JAX runner runs once per module (its step is
jitted: ~70 s of this file's time); the port starts from JAX's init,
carried across by ``load_flax``.

Tolerances.  The lr of every iteration, the log's keys, the checkpoint
steps and their meta are exact.  The first step's loss agrees to
LOSS_RTOL; later steps drift as the 3-step curve of
``tests/test_torch_neuralrecon_train.py`` does (its CURVE_RTOL, for the
reason its docstring gives: the gradient is sensitive to the forward at
ReLU kinks and Adam's first steps move every weight by about ±lr).  The
port against itself, interrupted and resumed or not, is bitwise equal.
"""
import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

import jax

from deep3dmap_tpu.datasets import build_dataloader as jax_build_dataloader
from deep3dmap_tpu.datasets import build_dataset as jax_build_dataset
from deep3dmap_tpu.datasets.synthetic import write_scannet_fixture as jax_write_fixture
from deep3dmap_tpu.models import build_reconstruction as jax_build_reconstruction
from deep3dmap_tpu.parallel import make_mesh
from deep3dmap_tpu.runners import build_runner as jax_build_runner
from deep3dmap_tpu.runners.checkpoint import load_checkpoint_raw as jax_load_raw
from deep3dmap_tpu.utils.config import Config as JaxConfig

from deep3dmap_tpu_torch.datasets.builder import build_dataloader, build_dataset
from deep3dmap_tpu_torch.models.builder import build_reconstruction
from deep3dmap_tpu_torch.runners.builder import build_runner
from deep3dmap_tpu_torch.runners.checkpoint import latest_checkpoint, load_meta, save_checkpoint
from deep3dmap_tpu_torch.runners.hooks import Hook
from deep3dmap_tpu_torch.tools import data_gen_scannet
from deep3dmap_tpu_torch.utils.config import Config
from deep3dmap_tpu_torch.utils.from_flax import load_jax_checkpoint

torch.set_num_threads(2)

LOSS_RTOL = 1e-5     # step 1
CURVE_RTOL = 1e-2    # later steps (tests/test_torch_neuralrecon_train.py)
JAX_EPOCHS = 2

CONFIG = """
N_VIEWS = 5
VOXEL_SIZE = 0.08
N_VOX = 24
pipeline = [
    dict(type="SeqResizeImage", size=(64, 48), depth_key="depth"),
    dict(type="SeqRandomTransformSpace", voxel_dim=(N_VOX, N_VOX, N_VOX),
         voxel_size=VOXEL_SIZE, random_rotation=False,
         random_translation=False, n_layers=3),
    dict(type="SeqIntrinsicsPoseToProjection", n_views=N_VIEWS, stride=4),
    dict(type="SeqNormalizeImages", mean=[127.5] * 3, std=[127.5] * 3),
]
data = dict(samples_per_gpu=1,
            train=dict(type="ScanNetDataset", datapath={datapath!r}, mode="train",
                       nviews=N_VIEWS, n_scales=2, img_size=(64, 48), n_vox=N_VOX,
                       voxel_size=VOXEL_SIZE, pipeline=pipeline))
model = dict(type="NeuralRecon", model_cfgs=dict(
    save_scene=True, N_LAYER=3, N_VOX=[N_VOX, N_VOX, N_VOX], VOXEL_SIZE=VOXEL_SIZE,
    TRAIN_NUM_SAMPLE=[512, 2048, 8192],
    BACKBONE2D=dict(ARC="fpn-mnas-0.5", INFER_MODE="batch"),
    FUSION=dict(FUSION_ON=True, FULL=True), LW=[1.0, 0.8, 0.64],
    THRESHOLDS=[0, 0, 0], POS_WEIGHT=1.5))
optimizer_config = dict(grad_clip=dict(max_norm=1.0))
lr_config = dict(policy="step", gamma=0.5, step=[1, 2])
runner = dict(type="EpochBasedRunner", runner_cfgs=dict(
    optimizer=dict(type="Adam", lr=1e-3, betas=(0.9, 0.999), weight_decay=0.0)))
"""


def _json_log(work_dir):
    """Every run's JSON log lines in the work dir, oldest run first."""
    out = []
    for name in sorted(f for f in os.listdir(work_dir) if f.endswith(".log.json")):
        with open(osp.join(work_dir, name)) as f:
            out += [json.loads(line) for line in f]
    return out


@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    root = tmp_path_factory.mktemp("runner")
    data = root / "data"
    jax_write_fixture(str(data), splits=("train",), n_frames=10)
    data_gen_scannet.main(["--datapath", str(data), "--mode", "train", "--n-views", "5",
                           "--min-angle", "1", "--min-distance", "0.01", "--n-proc", "1"])
    path = root / "cfg.py"
    path.write_text(CONFIG.format(datapath=str(data)))
    return str(path)


@pytest.fixture(scope="module")
def jax_run(cfg_path, tmp_path_factory):
    """JAX's runner for JAX_EPOCHS epochs: its init params, its JSON log (one
    line per iteration) and its checkpoints (one per epoch)."""
    cfg = JaxConfig.fromfile(cfg_path)
    work_dir = str(tmp_path_factory.mktemp("jax_wd"))
    loader = jax_build_dataloader(jax_build_dataset(cfg.data["train"]), shuffle=True, seed=0)
    runner_cfgs = dict(cfg.runner["runner_cfgs"], max_epochs=JAX_EPOCHS)
    runner = jax_build_runner(dict(type="EpochBasedRunner"), default_args=dict(
        framework=jax_build_reconstruction(cfg.model), work_dir=work_dir, seed=0,
        runner_cfgs=runner_cfgs, mesh=make_mesh(devices=jax.devices()[:1])))
    runner.setup(next(iter(loader)), optimizer=runner_cfgs["optimizer"],
                 lr_config=cfg.lr_config, optimizer_config=cfg.optimizer_config,
                 iters_per_epoch=len(loader))
    init = jax.tree_util.tree_map(np.asarray, runner.state.params)
    runner.register_training_hooks(checkpoint_config=dict(interval=1),
                                   log_config=dict(interval=1))
    runner.run([loader], [("train", 1)])
    ckpts = osp.join(work_dir, "checkpoints")
    return dict(init=init, log=_json_log(work_dir), work_dir=work_dir,
                ckpts={n: osp.join(ckpts, n) for n in os.listdir(ckpts) if n != "latest"})


def port_runner(cfg_path, work_dir, max_epochs, jax_init=None, optimizer_config="cfg",
                interval=1):
    """The port's runner as ``tools/train.py`` builds it, on the CPU."""
    cfg = Config.fromfile(cfg_path)
    loader = build_dataloader(build_dataset(cfg.data["train"], default_args=dict(device="cpu")),
                              shuffle=True, seed=0)
    runner_cfgs = dict(cfg.runner["runner_cfgs"], max_epochs=max_epochs)
    runner = build_runner(dict(type="EpochBasedRunner"), default_args=dict(
        framework=build_reconstruction(cfg.model, device="cpu"), work_dir=work_dir,
        seed=0, runner_cfgs=runner_cfgs))
    runner.setup(next(iter(loader)), optimizer=runner_cfgs["optimizer"],
                 lr_config=cfg.lr_config,
                 optimizer_config=cfg.optimizer_config if optimizer_config == "cfg"
                 else optimizer_config,
                 iters_per_epoch=len(loader))
    if jax_init is not None:
        runner.framework.load_flax(jax_init)
    runner.register_training_hooks(checkpoint_config=dict(interval=interval),
                                   log_config=dict(interval=1))
    return runner, loader


def _state_tensors(runner):
    st = runner.state
    out = {f"net.{k}": v for k, v in st.net.state_dict().items()}
    for i, v in enumerate(st.model_state["global_hidden"].volumes):
        out[f"hidden.{i}"] = v
    for p, s in st.optimizer.adam.state.items():
        out[f"adam.{id(p)}"] = torch.cat([s["exp_avg"].reshape(-1), s["exp_avg_sq"].reshape(-1)])
    return out


def test_losses_lr_and_log_keys_match_jax(cfg_path, jax_run, tmp_path):
    runner, loader = port_runner(cfg_path, str(tmp_path), JAX_EPOCHS, jax_init=jax_run["init"])
    runner.run([loader], [("train", 1)])
    port, ref = _json_log(str(tmp_path)), jax_run["log"]
    assert [list(r) for r in port] == [list(r) for r in ref]       # keys, in order
    assert [(r["epoch"], r["iter"], r["lr"]) for r in port] == \
        [(r["epoch"], r["iter"], r["lr"]) for r in ref]
    keys = ["loss", "tsdf_occ_loss_0", "tsdf_occ_loss_1", "tsdf_occ_loss_2"]
    np.testing.assert_allclose([port[0][k] for k in keys], [ref[0][k] for k in keys],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose([r["loss"] for r in port[1:]], [r["loss"] for r in ref[1:]],
                               rtol=CURVE_RTOL)


def test_checkpoints_at_interval_and_meta_match_jax(cfg_path, jax_run, tmp_path):
    runner, loader = port_runner(cfg_path, str(tmp_path), JAX_EPOCHS)
    runner.run([loader], [("train", 1)])
    ckpts = osp.join(str(tmp_path), "checkpoints")
    names = sorted(n for n in os.listdir(ckpts) if n != "latest")
    assert names == sorted(jax_run["ckpts"]) == ["ckpt_2", "ckpt_4"]
    assert latest_checkpoint(str(tmp_path)) == osp.join(ckpts, "ckpt_4")
    for n in names:
        assert load_meta(osp.join(ckpts, n)) == load_meta(jax_run["ckpts"][n])


def test_resume_continues_bitwise(cfg_path, tmp_path):
    whole, loader = port_runner(cfg_path, str(tmp_path / "whole"), 3)
    whole.run([loader], [("train", 1)])

    first, loader = port_runner(cfg_path, str(tmp_path / "cut"), 1)
    first.run([loader], [("train", 1)])
    resumed, loader = port_runner(cfg_path, str(tmp_path / "cut"), 3)
    assert resumed.resume() is True
    assert (resumed.epoch, resumed.iter, resumed.state.step) == (1, 2, 2)
    # the loader's shuffle counter is the loader's own (as in JAX, the
    # checkpoint does not hold it): the uninterrupted run's next epoch is its 2nd
    loader.epoch = 2
    resumed.run([loader], [("train", 1)])

    a, b = _state_tensors(whole), _state_tensors(resumed)
    assert len(a) == len(b)
    for (ka, va), vb in zip(a.items(), b.values()):
        assert torch.equal(va, vb), ka
    tail = _json_log(str(tmp_path / "whole"))[2:]
    cut = _json_log(str(tmp_path / "cut"))[2:]
    assert [r["loss"] for r in cut] == [r["loss"] for r in tail]


def test_resume_with_another_optimizer_config_raises(cfg_path, tmp_path):
    base, loader = port_runner(cfg_path, str(tmp_path), 1)
    base.run([loader], [("train", 1)])
    other, _ = port_runner(cfg_path, str(tmp_path), 2, optimizer_config={})   # no clip
    with pytest.raises(ValueError, match="SAME model and optimizer config"):
        other.resume()


def test_jax_checkpoint_resumes_in_the_port(cfg_path, jax_run, tmp_path):
    """JAX's epoch-1 checkpoint -> the port's: the weights, Adam's moments and
    count, the recurrent state and the step carry over exactly; the port's
    epoch 2 from there follows JAX's epoch 2."""
    raw = jax_load_raw(jax_run["ckpts"]["ckpt_2"])
    runner, _ = port_runner(cfg_path, str(tmp_path / "conv"), JAX_EPOCHS)
    state = load_jax_checkpoint(raw, runner.state)
    assert state.step == 2 and state.optimizer.count == 2
    for v, ref in zip(state.model_state["global_hidden"].volumes,
                      raw["model_state"]["global_hidden"]["volumes"]):
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref))
    save_checkpoint(str(tmp_path / "conv"), state,
                    meta=load_meta(jax_run["ckpts"]["ckpt_2"]))

    resumed, loader = port_runner(cfg_path, str(tmp_path / "conv"), JAX_EPOCHS)
    assert resumed.resume() is True
    assert (resumed.epoch, resumed.iter) == (1, 2)
    loader.epoch = 2
    resumed.run([loader], [("train", 1)])
    port, ref = _json_log(str(tmp_path / "conv")), jax_run["log"][2:]
    assert [r["lr"] for r in port] == [r["lr"] for r in ref]
    np.testing.assert_allclose(port[0]["loss"], ref[0]["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(port[1]["loss"], ref[1]["loss"], rtol=CURVE_RTOL)

    with pytest.raises(ValueError, match="optimizer structure"):
        plain, _ = port_runner(cfg_path, str(tmp_path / "plain"), 1, optimizer_config={})
        load_jax_checkpoint(raw, plain.state)


def test_train_val_workflow_logs_the_val_loss(cfg_path, tmp_path):
    """A ``[("train", 1), ("val", 1)]`` workflow: ``val`` runs ``val_fn``
    over its loader after each training epoch, and the logger reads the
    ``val_loss`` values the buffer kept on the device."""
    runner, loader = port_runner(cfg_path, str(tmp_path), 1)
    seen = []

    class Spy(Hook):
        def after_val_epoch(self, runner):
            runner.log_buffer.average()
            seen.append(dict(runner.log_buffer.output))

    runner.register_hook(Spy(), priority=80)     # before the logger clears it
    val_loader = build_dataloader(loader.dataset, shuffle=False)
    runner.run([loader, val_loader], [("train", 1), ("val", 1)])
    assert runner.epoch == 1 and runner.mode == "train"
    assert len(seen) == 1 and set(seen[0]) == {"val_loss"}
    assert np.isfinite(seen[0]["val_loss"]) and seen[0]["val_loss"] > 0
