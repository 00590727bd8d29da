"""LERF's runtime in the port against JAX's, on the CPU: the cosine lr
policy, ``IterBasedRunner`` on ``configs/lerf/lerf_synthetic.py`` (a 3-step
clip + Adam curve beside JAX's runner on the same batches, weights, draws
and importance samples; a checkpoint; a resume, also from JAX's checkpoint)
and the port's CLIs on both published configs.

Tolerances: the cosine schedule within 4 float32 eps times base_lr of
JAX's (measured: 1.5 ulps of the value; XLA's float32 ``cos`` is its own;
the step policy stays bit-equal).  Every step of the curve within
``LOG_RTOL`` 1e-4, the whole-slice rule: the port's ``sample_pdf`` results
are replayed into JAX's jitted step (a callback per step), since its jumps
would move a few rays' samples by a bin on an ulp of summation order
(``test_torch_lerf.py``) and Adam's first steps would carry that into
every later loss.  A JAX checkpoint loads exactly.
"""
import json
import logging
import os
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deep3dmap_tpu.models.frameworks.lerf as jlerf
import deep3dmap_tpu_torch.models.frameworks.lerf as tlerf
from deep3dmap_tpu.models.frameworks.lerf import LERFModel as JLERF
from deep3dmap_tpu.parallel import make_mesh
from deep3dmap_tpu.runners.checkpoint import load_checkpoint_raw as jax_load_raw
from deep3dmap_tpu.runners.checkpoint import save_checkpoint as jax_save_checkpoint
from deep3dmap_tpu.runners.iter_based_runner import IterBasedRunner as JRunner
from deep3dmap_tpu.runners.optim import build_lr_schedule as jax_schedule
from deep3dmap_tpu_torch.datasets.builder import build_dataset
from deep3dmap_tpu_torch.datasets.synthetic import (seeded_clip_state_dict,
                                                    seeded_dino_state_dict,
                                                    write_blender_fixture)
from deep3dmap_tpu_torch.models.frameworks.lerf import LERFModel
from deep3dmap_tpu_torch.runners.builder import build_runner
from deep3dmap_tpu_torch.runners.checkpoint import latest_checkpoint, load_meta, save_checkpoint
from deep3dmap_tpu_torch.runners.optim import build_lr_schedule
from deep3dmap_tpu_torch.tools import test as test_cli
from deep3dmap_tpu_torch.tools import train as train_cli
from deep3dmap_tpu_torch.utils.config import Config
from deep3dmap_tpu_torch.utils.from_flax import (load_flax_params, load_jax_checkpoint,
                                                 to_flax_adam_state, to_flax_params)
from deep3dmap_tpu_torch.utils.torch_import import import_npz_entries

torch.set_num_threads(2)
ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
SYN = osp.join(ROOT, "configs", "lerf", "lerf_synthetic.py")
PUB = osp.join(ROOT, "configs", "lerf", "lerf.py")
LOG_RTOL = 1e-4
STEPS = 3


@pytest.mark.parametrize("policy,total,base,kw", [
    ("cosineannealing", 16, 1e-3, dict(min_lr=1e-5)),
    ("cosine", 30000, 1e-2, dict(min_lr=1e-5)),
    ("cosineannealing", 24, 1e-3, dict(min_lr_ratio=0.1)),
    ("cosine", 7, 0.1, {}),
])
def test_cosine_schedule_matches_jax(policy, total, base, kw):
    port = build_lr_schedule(policy, base, total, iters_per_epoch=8, **kw)
    ref = jax.jit(jax_schedule(policy, base, total, iters_per_epoch=8, **kw))
    tgt = base * kw["min_lr_ratio"] if "min_lr_ratio" in kw else kw.get("min_lr", 0.0)
    tol = 4 * float(np.finfo(np.float32).eps) * base
    steps = sorted(set(range(0, min(total, 40))) | {total // 2, total - 1, total, total + 5})
    for k in steps:
        assert abs(port(k) - float(ref(jnp.int32(k)))) <= tol, k
    assert port(total + 5) == pytest.approx(tgt, abs=tol)


class FedLERF(LERFModel):
    """The port's framework drawing JAX's uniforms: each step takes the next
    key of JAX's runner chain (``rng, sub = split(rng)``)."""

    def __init__(self, key, *a, **kw):
        super().__init__(*a, **kw)
        self.key = key

    def draws(self, rng, n_rays, device=None):
        self.key, sub = jax.random.split(self.key)
        r1, _ = jax.random.split(sub)
        return {"u_pdf": torch.from_numpy(np.array(
            jax.random.uniform(r1, (n_rays, self.n_importance))))}


def _runner_args(cfg):
    return dict(optimizer=dict(cfg.runner["runner_cfgs"]["optimizer"]),
                lr_config=dict(cfg.lr_config), optimizer_config=dict(cfg.optimizer_config),
                iters_per_epoch=cfg.data["train"]["n_batches"])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The port's ``IterBasedRunner`` on lerf_synthetic.py for 3 steps (of
    its 16-step schedule), then JAX's on the same batches, weights, uniforms
    and (replayed) importance samples; both logs and JAX's checkpoint."""
    cfg = Config.fromfile(SYN)
    ds = build_dataset(cfg.data["train"], default_args=dict(device="cpu"))
    batches = list(ds)
    jfw = JLERF(dict(cfg.model["model_cfgs"]))
    wd = str(tmp_path_factory.mktemp("lerf_jax"))
    jr = JRunner(jfw, work_dir=wd, mesh=make_mesh(devices=jax.devices()[:1]),
                 runner_cfgs=dict(cfg.runner["runner_cfgs"]))
    jr.setup(batches[0], **_runner_args(cfg))
    key = jax.numpy.asarray(np.array(jr.state.rng))
    params0 = jax.tree_util.tree_map(np.array, jr.state.params)

    fw = FedLERF(key, dict(cfg.model["model_cfgs"]), device="cpu")
    tr = build_runner(dict(type="IterBasedRunner"), default_args=dict(
        framework=fw, work_dir=str(tmp_path_factory.mktemp("lerf_port")),
        runner_cfgs=dict(cfg.runner["runner_cfgs"])))
    tr.setup(batches[0], **_runner_args(cfg))
    load_flax_params(tr.state.net, params0)
    schedule_iters = tr.max_iters
    z = []
    with pytest.MonkeyPatch.context() as mp:
        orig = tlerf.sample_pdf

        def record(*a, **kw):
            z.append(orig(*a, **kw))
            return z[-1]
        mp.setattr(tlerf, "sample_pdf", record)
        tr.run([batches], [("train", -1)], max_iters=STEPS)
        queue = [np.asarray(t.detach().numpy(), np.float32) for t in z]
        shape = jax.ShapeDtypeStruct(queue[0].shape, jnp.float32)
        mp.setattr(jlerf, "sample_pdf",
                   lambda *a, **kw: jax.pure_callback(lambda: queue.pop(0), shape))
        jr.run([batches], [("train", -1)], max_iters=STEPS)
    assert len(z) == STEPS and not queue
    logs = {k: list(v) for k, v in jr.log_buffer.val_history.items()}
    path = jax_save_checkpoint(wd, jr.state, meta=dict(epoch=1, iter=STEPS))
    return dict(cfg=cfg, ds=ds, batches=batches, logs=logs, port=tr,
                schedule_iters=schedule_iters, path=path,
                params=jax.tree_util.tree_map(np.array, jr.state.params),
                opt_state=jr.state.opt_state)


def test_curve_matches_jax_runner(jax_run):
    j = jax_run
    tr = j["port"]
    assert tr.state.rng is not None and j["schedule_iters"] == 16
    got = {k: [float(x) for x in v] for k, v in tr.log_buffer.val_history.items()}
    assert set(got) >= set(j["logs"]) - {"time", "data_time"}
    for k, want in j["logs"].items():
        if k in ("time", "data_time"):
            continue
        assert len(got[k]) == len(want) == STEPS
        for a, b in zip(got[k], want):
            assert a == pytest.approx(b, rel=LOG_RTOL), (k, got[k], want)
    assert tr.iter == tr.state.step == STEPS
    assert tr.current_lr() == pytest.approx(float(jax_schedule(
        "cosineannealing", 1e-3, 16, min_lr=1e-5)(STEPS)), rel=1e-6)


def test_jax_checkpoint_resumes_in_the_port(jax_run, tmp_path):
    j = jax_run
    raw = jax_load_raw(j["path"])
    wd = str(tmp_path)
    cfg = j["cfg"]
    runner = build_runner(dict(type="IterBasedRunner"), default_args=dict(
        framework=LERFModel(dict(cfg.model["model_cfgs"]), device="cpu"), work_dir=wd,
        runner_cfgs=dict(cfg.runner["runner_cfgs"])))
    runner.setup(j["batches"][0], **_runner_args(cfg))
    runner.state = load_jax_checkpoint(raw, runner.state)
    net = runner.state.net
    for a, b in zip(jax.tree_util.tree_leaves(to_flax_params(net)),
                    jax.tree_util.tree_leaves(j["params"])):
        np.testing.assert_array_equal(a, b)
    adam = j["opt_state"][1][0]
    got = to_flax_adam_state(net, runner.state.optimizer.adam)
    assert got["count"] == int(adam.count) == runner.state.optimizer.count == STEPS
    for k in ("mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves(got[k]),
                        jax.tree_util.tree_leaves(getattr(adam, k))):
            np.testing.assert_array_equal(a, np.asarray(b))
    save_checkpoint(wd, runner.state, meta=load_meta(j["path"]))
    resumed = train_cli.main([SYN, "--work-dir", wd, "--resume-from", "auto",
                              "--device", "cpu", "--cfg-options", "runner.runner_cfgs.max_iters=5"])
    assert resumed.iter == resumed.state.step == 5
    assert latest_checkpoint(wd).endswith("ckpt_5")


@pytest.fixture
def messages():
    got = []
    handler = logging.Handler()
    handler.emit = lambda record: got.append(record.getMessage())
    logger = logging.getLogger("deep3dmap_tpu_torch")
    logger.addHandler(handler)
    yield got
    logger.removeHandler(handler)


def test_synthetic_config_through_the_clis(tmp_path, messages):
    """16 iterations (checkpoints at 8 and 16, the cosine lr in the JSON
    log every 4), a resume to 20, then ``tools/test.py`` on the test split."""
    wd = str(tmp_path)
    runner = train_cli.main([SYN, "--work-dir", wd, "--device", "cpu"])
    assert runner.iter == runner.state.step == 16
    ckpts = sorted(os.listdir(osp.join(wd, "checkpoints")))
    assert {"ckpt_8", "ckpt_16"} <= set(ckpts)
    recs = [json.loads(line) for f in os.listdir(wd) if f.endswith(".log.json")
            for line in open(osp.join(wd, f))]
    sched = build_lr_schedule("cosineannealing", 1e-3, 16, min_lr=1e-5)
    assert [r["iter"] for r in recs] == [4, 8, 12, 16]
    assert [r["lr"] for r in recs] == [sched(k) for k in (4, 8, 12, 16)]
    assert all(np.isfinite(r["loss"]) and "clip_loss" in r for r in recs)
    assert any(m.startswith("Iter [4]") for m in messages)
    resumed = train_cli.main([SYN, "--work-dir", wd, "--resume-from", "auto", "--device",
                              "cpu", "--cfg-options", "runner.runner_cfgs.max_iters=20"])
    assert resumed.state.step == 20 and latest_checkpoint(wd).endswith("ckpt_20")
    del messages[:]
    test_cli.main([SYN, "--work-dir", wd, "--checkpoint", "auto", "--device", "cpu"])
    assert "collected rgb (512, 3), depth (512,)" in messages


def test_published_config_through_both_clis(tmp_path, messages):
    """``lerf.py`` as published but for the paths and its sizes: the
    hash-grid RGB field and the proposal sampler on a Blender-layout
    fixture, seeded CLIP and DINO checkpoints imported by the port; its
    ``data.test`` is deleted (``_delete_``), so ``tools/test.py`` takes a
    test split from ``--cfg-options``."""
    lego = write_blender_fixture(str(tmp_path / "lego"), splits=(("train", 3), ("test", 1)),
                                 img_wh=(32, 32))
    clip, dino = str(tmp_path / "clip.npz"), str(tmp_path / "dino.npz")
    np.savez(clip, **import_npz_entries("clip", seeded_clip_state_dict(
        0, width=64, layers=1, patch=8, image=32, text_width=32, text_layers=1, embed=64,
        vocab=64, ctx=8)))
    np.savez(dino, **import_npz_entries("dino", seeded_dino_state_dict(
        0, dim=192, depth=2, patch=8, grid=4)))
    assert "test" not in Config.fromfile(PUB).data
    opts = [f"data.train.image_dataset.data_dir={lego}", "data.train.image_dataset.img_wh=(32,32)",
            "data.train.rays_per_batch=64", "data.train.n_batches=2",
            "data.train.clip_n_dims=64", "data.train.dino_n_dims=192",
            f"data.train.clip_npz={clip}", f"data.train.dino_npz={dino}",
            "data.train.tile_size_range=(0.25,0.5)", "data.train.tile_size_res=2",
            "data.train.dino_layer=1",
            "model.model_cfgs.clip_n_dims=64", "model.model_cfgs.dino_n_dims=192",
            f"model.model_cfgs.clip_weights={clip}", "model.model_cfgs.N_proposal=16",
            "model.model_cfgs.N_importance=8", "model.model_cfgs.rgb_grid_levels=4",
            "model.model_cfgs.rgb_grid_log2=10", "model.model_cfgs.rgb_grid_end=64",
            "model.model_cfgs.num_lerf_samples=4", "runner.runner_cfgs.max_iters=3"]
    wd = str(tmp_path / "wd")
    runner = train_cli.main([PUB, "--work-dir", wd, "--device", "cpu", "--cfg-options", *opts])
    fw = runner.framework
    assert fw.rgb_field_type == "hashgrid" and fw.image_encoder._vit is not None
    assert runner.state.step == 3 and hasattr(runner.state.net, "proposal")
    test_split = [o.replace("data.train", "data.test") for o in opts if o.startswith("data.")]
    test_split += ["data.test.type=LERFRayDataset", "data.test.image_dataset.type=BlenderDataset",
                   "data.test.image_dataset.split=test", "data.test.seed=9"]
    del messages[:]
    test_cli.main([PUB, "--work-dir", wd, "--checkpoint", "auto", "--device", "cpu",
                   "--cfg-options", *[o for o in opts if not o.startswith("data.")],
                   *test_split])
    assert "collected rgb (128, 3), depth (128,)" in messages
