"""GNeRF through ``StateMachineRunner`` and the CLIs, on the CPU.

- The port's runner keys one Adam by each of GanNerf's five top-level param
  collections, as JAX's runner keeps ``opt_state`` (its ``network_names``
  lists three).
- ``configs/gnerf/gnerf_synthetic.py``'s model through ``A -> ABAB -> B``
  (state steps cut to one epoch each, 4 images, B 2) against JAX's runner,
  the port fed JAX's draws from the runner's own key chain: each
  iteration's per-sequence logs, and after each sequence only the
  collections ``optseq2netnames`` names have moved (the one val pose only
  when the batch holds index 0: trap 2 of ``modulars/embeddings.py``).
  The logs agree to 1e-2 relative (measured 2.1e-3), the first
  iteration's to 2e-3 (measured 7.4e-4), not to float32 rounding: the
  importance samples are drawn on each side (``test_torch_gnerf.py``:
  ``sample_pdf``'s jumps move a few rays' fine samples), and Adam with
  beta1 = 0 moves each weight by lr times the sign of its gradient at the
  first step, so a near-zero gradient of the other sign puts that weight
  2 lr away for the sequences after it.
- That JAX run's checkpoint (five Adam chains, ``it``, the spectral-norm
  state) loads into the runner the train CLI builds, exactly, and resumes
  through the CLI.
- ``tools/train.py`` runs ``gnerf_synthetic.py`` to its end and
  ``tools/test.py`` renders its test split from the checkpoint;
  ``blender.py`` and ``dtu.py`` run one epoch on fixture trees at
  ``tests/test_real_configs.py``'s reduced sizes, each then through
  ``tools/test.py``.
"""
import logging
import os.path as osp

import numpy as np
import pytest
import torch

import jax

from deep3dmap_tpu.datasets.builder import NumpyLoader as JLoader
from deep3dmap_tpu.datasets.nerf_synthetic import SyntheticNerfDataset as JDataset
from deep3dmap_tpu.models.frameworks.gnerf import GanNerf as JGanNerf
from deep3dmap_tpu.parallel import make_mesh
from deep3dmap_tpu.runners.checkpoint import load_checkpoint_raw as jax_load_raw
from deep3dmap_tpu.runners.checkpoint import save_checkpoint as jax_save_checkpoint
from deep3dmap_tpu.runners.state_machine_runner import StateMachineRunner as JRunner
from deep3dmap_tpu.utils.config import Config as JaxConfig
from deep3dmap_tpu_torch.datasets.builder import NumpyLoader
from deep3dmap_tpu_torch.datasets.synthetic import write_blender_fixture, write_dtu_fixture
from deep3dmap_tpu_torch.models.frameworks.gnerf import GanNerf
from deep3dmap_tpu_torch.runners.builder import build_runner
from deep3dmap_tpu_torch.runners.checkpoint import latest_checkpoint, load_meta, save_checkpoint
from deep3dmap_tpu_torch.tools import test as test_cli
from deep3dmap_tpu_torch.tools import train as train_cli
from deep3dmap_tpu_torch.utils.from_flax import (load_flax_params, load_jax_checkpoint,
                                                 to_flax_adam_state, to_flax_params,
                                                 to_flax_state)
from gnerf_helpers import jax_draws, np_tree, rel

torch.set_num_threads(2)
ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG = osp.join(ROOT, "configs", "gnerf", "gnerf_synthetic.py")
COLLECTIONS = ["generator", "discriminator", "inv_net", "train_poses", "val_poses"]
FIRST_RTOL = 2e-3
LOG_RTOL = 1e-2
STEPS = [0, 1, 2]


class FedGanNerf(GanNerf):
    """The port's framework drawing JAX's numbers: each ``draws`` call
    takes the next key of JAX's runner chain (``rng, sub = split(rng)``
    per sequence step)."""

    def __init__(self, jfw, key, *a, **kw):
        super().__init__(*a, **kw)
        self.jfw, self.key = jfw, key

    def draws(self, rng, opt_seq, batch_size, device=None):
        self.key, sub = jax.random.split(self.key)
        return jax_draws(self.jfw, sub, opt_seq, batch_size)


def _cfg():
    cfg = JaxConfig.fromfile(CONFIG)
    model = dict(cfg.model["model_cfgs"])
    data = {k: v for k, v in cfg.data["train"].items() if k != "type"}
    data["n_images"] = 4
    return cfg, model, data


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's runner, 3 epochs of 2 iterations (A, ABAB, B), every
    iteration's logs by sequence, and its checkpoint."""
    cfg, model, data = _cfg()
    ds = JDataset(**data)
    jfw = JGanNerf(model)
    jfw.set_info_from_datasets([ds])
    loader = JLoader(ds, batch_size=cfg.data["samples_per_gpu"], shuffle=True, seed=0)
    wd = str(tmp_path_factory.mktemp("gnerf_jax"))
    runner = dict(cfg.runner)
    jr = JRunner(jfw, work_dir=wd, mesh=make_mesh(devices=jax.devices()[:1]),
                 runner_cfgs=dict(runner["runner_cfgs"]), state_seq=runner["state_seq"],
                 state_steps=STEPS, max_epochs=3)
    jr.setup(next(iter(loader)), optimizer=runner["runner_cfgs"]["optimizer"])
    key = jax.numpy.asarray(np.array(jr.state.rng))
    params0, mstate0 = np_tree(jr.state.params), np_tree(jr.state.model_state)
    iters = []
    for epoch in range(3):
        jr.epoch = epoch
        jr.state_switch()
        for batch in loader:
            jr.log_buffer.clear()
            jr.run_multi_iter(batch)
            iters.append(dict(state=jr.cur_state,
                              logs={k: v[-1] for k, v in jr.log_buffer.val_history.items()}))
    path = jax_save_checkpoint(wd, jr.state, meta=dict(epoch=3, iter=6))
    return dict(jfw=jfw, key=key, params0=params0, mstate0=mstate0, iters=iters, path=path,
                params=np_tree(jr.state.params), opt_state=jr.state.opt_state,
                model_state=np_tree(jr.state.model_state), data=data, model=model, cfg=cfg)


def test_runner_keeps_one_adam_per_collection(tmp_path):
    runner = train_cli.main([CONFIG, "--work-dir", str(tmp_path), "--max-epochs", "0",
                             "--device", "cpu"])
    assert list(runner.state.optimizer) == COLLECTIONS
    assert runner.framework.network_names == COLLECTIONS[:3]
    assert runner.state.rng.device == torch.device("cpu")
    n = {k: sum(p.numel() for p in getattr(runner.state.net, k).parameters())
         for k in COLLECTIONS}
    assert {k: len(o.params) for k, o in runner.state.optimizer.items()} == \
        {k: len(list(getattr(runner.state.net, k).parameters())) for k in COLLECTIONS}
    assert n["train_poses"] == 8 * 9 and n["val_poses"] == 9


def test_states_match_jax_runner(jax_run, tmp_path):
    j = jax_run
    cfg = j["cfg"]
    ds = JDataset(**j["data"])
    fw = FedGanNerf(j["jfw"], j["key"], j["model"], device="cpu")
    fw.set_info_from_datasets([ds])
    tr = build_runner(dict(type="StateMachineRunner", state_seq=cfg.runner["state_seq"],
                           state_steps=STEPS, max_epochs=3),
                      default_args=dict(framework=fw, work_dir=str(tmp_path),
                                        runner_cfgs=dict(cfg.runner["runner_cfgs"])))
    loader = NumpyLoader(ds, batch_size=cfg.data["samples_per_gpu"], shuffle=True, seed=0)
    tr.setup(next(iter(loader)))
    net = tr.state.net
    load_flax_params(net, j["params0"])
    tr.state.model_state = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                                  j["mstate0"])
    assert list(tr.state.optimizer) == COLLECTIONS

    moved_by = {}
    orig_step = tr._step

    def step(batch, names=None, **kw):
        before = {k: [p.detach().clone() for p in getattr(net, k).parameters()]
                  for k in COLLECTIONS}
        out = orig_step(batch, names, **kw)
        moved_by[kw["opt_seq"]] = {k for k in COLLECTIONS if any(
            not torch.equal(a, b) for a, b in zip(before[k], getattr(net, k).parameters()))}
        return out
    tr._step = step

    i, errs = 0, {}
    for epoch in range(3):
        tr.epoch = epoch
        tr.state_switch()
        for batch in loader:
            logs = tr.run_multi_iter(batch)
            want = j["iters"][i]
            assert tr.cur_state == want["state"]
            assert set(logs) == set(want["logs"])
            for k, v in want["logs"].items():
                errs[(i, k)] = rel(v, float(logs[k]))
            for seq, moved in moved_by.items():
                # the one val pose moves only when the batch holds index 0:
                # the gather drops the gradient of out-of-range indices
                named = set(fw.optseq2netnames(seq))
                assert moved == named or (moved < named and seq.startswith("val")), \
                    (seq, moved)
            i += 1
    assert i == len(j["iters"]) == 6
    first = max(e for (n, _), e in errs.items() if n == 0)
    worst = max(errs, key=errs.get)
    assert first < FIRST_RTOL and errs[worst] < LOG_RTOL, (first, worst, errs[worst])
    assert int(tr.state.model_state["it"]) == int(j["model_state"]["it"]) == 4


def test_jax_checkpoint_resumes_in_the_port(jax_run, tmp_path):
    j = jax_run
    raw = jax_load_raw(j["path"])
    assert set(raw["opt_state"]) == set(COLLECTIONS)
    wd = str(tmp_path / "port")
    opts = ["--cfg-options", "data.train.n_images=4", "runner.state_steps=[0,1,2]"]
    runner = train_cli.main([CONFIG, "--work-dir", wd, "--max-epochs", "0", "--device", "cpu",
                             *opts])
    runner.state = load_jax_checkpoint(raw, runner.state)
    net = runner.state.net
    for a, b in zip(jax.tree_util.tree_leaves(to_flax_params(net)),
                    jax.tree_util.tree_leaves(j["params"])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(to_flax_state(runner.state.model_state)),
                    jax.tree_util.tree_leaves(j["model_state"])):
        np.testing.assert_array_equal(a, b)
    for name in COLLECTIONS:
        opt = runner.state.optimizer[name]
        got = to_flax_adam_state(getattr(net, name), opt.adam)
        want = j["opt_state"][name][0]
        assert got["count"] == int(want.count) == opt.count
        for k in ("mu", "nu"):
            for a, b in zip(jax.tree_util.tree_leaves(got[k]),
                            jax.tree_util.tree_leaves(np_tree(getattr(want, k)))):
                np.testing.assert_array_equal(a, b)
    save_checkpoint(wd, runner.state, meta=load_meta(j["path"]))
    resumed = train_cli.main([CONFIG, "--work-dir", wd, "--resume-from", "auto",
                              "--max-epochs", "4", "--device", "cpu", *opts])
    assert resumed.cur_state == "B" and resumed.epoch == 4
    step = int(j["iters"] and runner.state.step)
    assert resumed.state.step == step + 2 * 2
    assert latest_checkpoint(wd).endswith(f"ckpt_{step + 4}")


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


def _test_outputs(config, wd, opts, messages):
    del messages[:]
    test_cli.main([config, "--work-dir", wd, "--checkpoint", "auto", "--device", "cpu", *opts])
    return [m for m in messages if m.startswith("collected")]


def test_train_and_test_cli_synthetic(tmp_path, messages):
    wd = str(tmp_path)
    runner = train_cli.main([CONFIG, "--work-dir", wd, "--device", "cpu"])
    assert "state switch: A -> ABAB" in messages and "state switch: ABAB -> B" in messages
    assert (runner.epoch, runner.cur_state) == (6, "B")
    assert latest_checkpoint(wd) is not None
    got = _test_outputs(CONFIG, wd, [], messages)
    assert got == ["collected rgb (2, 32, 32, 3), depth (2, 32, 32)"]


SMALL = ["model.model_cfgs.patch_size=16", "model.model_cfgs.inv_size=16",
         "model.model_cfgs.fc_depth=2", "model.model_cfgs.fc_dim=16",
         "model.model_cfgs.N_samples=4", "model.model_cfgs.N_importance=4",
         "model.model_cfgs.ndf=8", "model.model_cfgs.inv_depth=2",
         "runner.state_steps=[0,1,2]", "workflow=[('train',1)]"]


@pytest.mark.parametrize("config", ["blender", "dtu"])
def test_published_configs_through_both_clis(config, tmp_path, messages):
    """``blender.py`` and ``dtu.py`` as published but for the data paths and
    ``tests/test_real_configs.py``'s reduced model (16² images, a 2x16 MLP,
    4 + 4 samples, state steps [0, 1, 2]): three epochs through A, ABAB
    and B, then ``tools/test.py`` on the test split."""
    if config == "blender":
        root = write_blender_fixture(str(tmp_path / "lego"),
                                     splits=(("train", 4), ("val", 2), ("test", 2)),
                                     img_wh=(32, 32))
        wh = "(16,16)"
        data = [f"data.{s}.data_dir={root}" for s in ("train", "val", "test")]
        data += [f"data.{s}.img_wh={wh}" for s in ("train", "val", "test")]
    else:
        # 16 views: 2 in the val split, which dtu.py tests on at B 2
        root = write_dtu_fixture(str(tmp_path / "dtu"), n_views=16, img_wh=(32, 24))
        wh = "(16,12)"
        data = [f"data.{s}.data_dir={root}" for s in ("train", "val", "test")]
        data += [f"data.{s}.img_wh={wh}" for s in ("train", "val", "test")]
    opts = ["--cfg-options", *data, f"model.model_cfgs.img_wh={wh}", *SMALL]
    cfg_path = osp.join(ROOT, "configs", "gnerf", f"{config}.py")
    wd = str(tmp_path / "wd")
    runner = train_cli.main([cfg_path, "--work-dir", wd, "--max-epochs", "3", "--device",
                             "cpu", *opts])
    assert (runner.epoch, runner.cur_state) == (3, "B")
    assert len(runner.state.optimizer) == 5
    got = _test_outputs(cfg_path, wd, opts, messages)
    w, h = eval(wh)
    assert got == [f"collected rgb (2, {h}, {w}, 3), depth (2, {h}, {w})"]
