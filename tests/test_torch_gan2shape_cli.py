"""Gan2Shape through the port's entry points on the CPU, against the JAX
package: ``configs/gan2shape/celeba_synthetic.py`` unchanged, with
``use_mask=True`` and a parsing ``.npz`` (from a JAX ``FaceParser`` init)
given by ``--cfg-options``.

- ``tools/train.py`` builds ``Gan2ShapeRunner`` from ``RUNNERS``, derives
  each instance's mask with ``parse_mask``, runs the config's 2 epochs with
  its hooks (the JSON log under JAX's ``s1_``/``s2_``/``s3_`` keys) and
  writes a checkpoint per epoch; ``--resume-from`` epoch 1's checkpoint
  runs epoch 2 again, and its heads, Adam moments and step generator end
  bitwise equal to the uninterrupted run's; ``tools/test.py`` reads the
  checkpoint's heads into ``forward_test``.
- The masked step-1 loss of the instance equals JAX's with JAX's mask, the
  JAX init carried across (rtol 1e-4, ``tests/test_torch_gan2shape.py``'s
  step-1 tolerance); the masks agree to 1e-6 (their class maps are equal).
- A JAX ``Gan2ShapeRunner`` checkpoint (orbax, after Adam updates of every
  head) loads into the port's runner (``utils/from_flax.py::
  load_jax_checkpoint``): heads, each head's Adam state, the frozen GAN and
  the centres exactly; the port's next Adam step of each head equals optax's
  from the loaded state given the port's gradients (the runner tests'
  tolerance); saved as the port's checkpoint it resumes through the CLI.
"""
import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deep3dmap_tpu.datasets.gan_faces import SyntheticGanFaceDataset as JDataset
from deep3dmap_tpu.models.frameworks import gan2shape as JG
from deep3dmap_tpu.models.parsing.bisenet_fp import FaceParser as JFaceParser
from deep3dmap_tpu.parallel import make_mesh
from deep3dmap_tpu.runners.checkpoint import load_checkpoint_raw as jax_load_raw
from deep3dmap_tpu.runners.checkpoint import save_checkpoint as jax_save_checkpoint
from deep3dmap_tpu.runners.gan2shape_runner import Gan2ShapeRunner as JRunner
from deep3dmap_tpu.utils.config import Config as JaxConfig
from deep3dmap_tpu_torch.models.frameworks import gan2shape as TG
from deep3dmap_tpu_torch.runners.checkpoint import (latest_checkpoint, load_checkpoint_raw,
                                                    load_meta, save_checkpoint)
from deep3dmap_tpu_torch.tools import test as test_cli
from deep3dmap_tpu_torch.tools import train as train_cli
from deep3dmap_tpu_torch.utils.from_flax import (load_jax_checkpoint, to_flax_grads,
                                                 to_flax_params)

torch.set_num_threads(2)
ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG = osp.join(ROOT, "configs", "gan2shape", "celeba_synthetic.py")
HEADS = ("depth_head", "albedo_head", "view_head", "light_head", "encoder_head")


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The parsing ``.npz`` (a JAX ``FaceParser`` init) and a ``gan_ckpt``
    (a JAX init's generator and discriminator) in ``tools/import_weights.py``'s
    layout; the JAX framework of the config with the mask and its init."""
    root = tmp_path_factory.mktemp("g2s_files")
    parsing = str(root / "bisenet.npz")
    np.savez(parsing, params=np.array(_np(JFaceParser(seed=1).params), dtype=object))
    cfg = JaxConfig.fromfile(CONFIG)
    model_cfgs = dict(cfg.model["model_cfgs"], use_mask=True, parsing_ckpt=parsing)
    jfw = JG.Gan2Shape(model_cfgs)
    batch = JDataset(n_samples=4, image_size=32, z_dim=32).setup_input(0)
    params, mstate = jfw.init(jax.random.PRNGKey(0), batch)
    gan = str(root / "stylegan2.npz")
    np.savez(gan, g=np.array(_np(mstate["gan_params"]), dtype=object),
             d=np.array(_np(mstate["disc_params"]), dtype=object))
    return dict(parsing=parsing, gan=gan, model_cfgs=dict(model_cfgs, gan_ckpt=gan),
                batch=batch, jfw=jfw, params=params, mstate=mstate)


def _opts(files, *extra):
    return ["--device", "cpu", "--cfg-options", "model.model_cfgs.use_mask=True",
            f"model.model_cfgs.parsing_ckpt={files['parsing']}", *extra]


def _train(files, wd, *args):
    return train_cli.main([CONFIG, "--work-dir", str(wd), *args, *_opts(files)])


def _snapshot(runner):
    heads = {k: v.clone() for k, v in runner.net.state_dict().items()}
    moments = [(o.count, [t.clone() for s in o.adam.state.values()
                          for t in (s["exp_avg"], s["exp_avg_sq"])])
               for o in runner.optimizers.values()]
    return heads, moments, runner.rng.get_state().clone()


@pytest.fixture(scope="module")
def cli_runs(files, tmp_path_factory):
    """The config's 2 epochs; and epoch 2 again, resumed from epoch 1's
    checkpoint in another work dir."""
    wd = tmp_path_factory.mktemp("g2s_wd")
    first = _train(files, wd)
    ckpts = sorted(os.listdir(wd / "checkpoints"))
    resumed = _train(files, tmp_path_factory.mktemp("g2s_resumed"), "--resume-from",
                     str(wd / "checkpoints" / "ckpt_12"))
    return dict(wd=wd, first=first, ckpts=ckpts, straight=_snapshot(first),
                resumed=_snapshot(resumed), resumed_runner=resumed)


def test_train_cli_runs_the_config_with_the_mask(cli_runs):
    r = cli_runs["first"]
    assert type(r).__name__ == "Gan2ShapeRunner" and r.framework.use_mask
    assert (r.epoch, r.iter, r.step) == (2, 2, 24)          # (4 + 4 + 4) steps an epoch
    assert cli_runs["ckpts"] == ["ckpt_12", "ckpt_24", "latest"]
    raw = load_checkpoint_raw(osp.join(cli_runs["wd"], "checkpoints", "ckpt_24"), "cpu")
    assert set(raw["optimizer"]) == set(HEADS) and "rng" in raw
    assert load_meta(osp.join(cli_runs["wd"], "checkpoints", "ckpt_24")) == dict(epoch=2, iter=2)
    # the instance's mask came from the parser the config names
    assert r.framework._parser is not None
    logs = [f for f in os.listdir(cli_runs["wd"]) if f.endswith(".log.json")]
    with open(osp.join(cli_runs["wd"], sorted(logs)[0])) as f:
        lines = [json.loads(line) for line in f]
    assert [x["iter"] for x in lines] == [1, 2]
    keys = {"s1_loss", "s1_loss_l1", "s2_loss_rec", "s3_step3_l1"}
    assert all(keys <= set(x) and all(np.isfinite(x[k]) for k in keys) for x in lines)


def test_resume_continues_bitwise(cli_runs):
    """Epoch 2 resumed from epoch 1's checkpoint equals epoch 2 of the run
    that wrote it: heads, each head's Adam count and moments, and the step
    generator."""
    r = cli_runs["resumed_runner"]
    assert (r.epoch, r.step) == (2, 24)
    (h1, m1, g1), (h2, m2, g2) = cli_runs["resumed"], cli_runs["straight"]
    assert h1.keys() == h2.keys() and all(torch.equal(h1[k], h2[k]) for k in h1)
    for (c1, t1), (c2, t2) in zip(m1, m2):
        assert c1 == c2 and all(torch.equal(a, b) for a, b in zip(t1, t2))
    assert torch.equal(g1, g2)


def test_test_cli_reads_the_checkpoint(cli_runs, files, monkeypatch):
    seen = []
    orig = TG.Gan2Shape.forward_test

    def spy(self, net, state, batch):
        seen.append({k: v.clone() for k, v in net.state_dict().items()})
        return orig(self, net, state, batch)
    monkeypatch.setattr(TG.Gan2Shape, "forward_test", spy)
    res = test_cli.main([CONFIG, "--work-dir", str(cli_runs["wd"]), "--checkpoint", "auto",
                         *_opts(files)])
    assert res is None               # the dataset has no evaluate
    want = load_checkpoint_raw(latest_checkpoint(str(cli_runs["wd"])), "cpu")["net"]
    assert len(seen) == 2            # the test split's 2 instances
    assert all(torch.equal(seen[0][k], want[k]) for k in want)


def test_masked_step1_loss_matches_jax(files):
    batch, jfw, params, mstate = (files[k] for k in ("batch", "jfw", "params", "mstate"))
    jmask = np.asarray(jfw.parse_mask(jnp.asarray(batch["input_im"])))
    jtotal, jlog, _ = jfw.forward_step1(params, mstate, dict(batch, input_mask=jmask),
                                        jax.random.PRNGKey(1))

    tfw = TG.Gan2Shape(files["model_cfgs"], device="cpu")
    tfw.init(0, batch)
    net = tfw.load_flax(_np(params), _np(jfw.perceptual.params))
    tmask = tfw.parse_mask(batch["input_im"])
    assert tmask.shape == (1, 32, 32, 1) and 0.0 < float(tmask.mean()) < 1.0
    np.testing.assert_allclose(tmask.numpy(), jmask, atol=1e-6, rtol=0)
    ttotal, tlog, _ = tfw.forward_step1(net, {}, dict(batch, input_mask=tmask))
    np.testing.assert_allclose(float(ttotal.detach()), float(jtotal), rtol=1e-4)
    for k in ("loss_l1", "loss_perc", "loss_smooth"):
        np.testing.assert_allclose(float(tlog[k].detach()), float(jlog[k]), rtol=1e-4,
                                   err_msg=k)
    unmasked, _, _ = tfw.forward_step1(net, {}, batch)
    assert abs(float(unmasked.detach()) - float(ttotal.detach())) > 1e-3      # the mask gates the loss


def test_jax_checkpoint_resumes_in_the_port(files, tmp_path):
    """JAX's runner state after an Adam update of every head -> orbax ->
    the port's runner; one more port step per head against optax; the port's
    checkpoint of it resumes through the CLI."""
    cfg = JaxConfig.fromfile(CONFIG)
    batch = files["batch"]
    jfw = JG.Gan2Shape(files["model_cfgs"])
    jr = JRunner(jfw, work_dir=str(tmp_path / "jax"), mesh=make_mesh(devices=jax.devices()[:1]),
                 runner_cfgs=dict(cfg.runner["runner_cfgs"]), stage_iters=(1, 1, 1), num_stage=1)
    jr.setup(batch, optimizer=cfg.runner["runner_cfgs"]["optimizer"])
    tx = optax.adam(cfg.runner["runner_cfgs"]["optimizer"]["lr"])
    rs = np.random.RandomState(3)
    params, opt_state = dict(jr.state.params), dict(jr.state.opt_state)
    for _ in range(2):
        for h in HEADS:
            g = jax.tree_util.tree_map(lambda a: jnp.asarray(rs.randn(*a.shape), a.dtype),
                                       params[h])
            upd, opt_state[h] = tx.update(g, opt_state[h], params[h])
            params[h] = optax.apply_updates(params[h], upd)
    jr.state = jr.state.replace(params=params, opt_state=opt_state, step=2)
    path = jax_save_checkpoint(str(tmp_path / "jax"), jr.state, meta=dict(epoch=1, iter=1))
    raw = jax_load_raw(path)

    port_wd = tmp_path / "port"
    runner = train_cli.main([CONFIG, "--work-dir", str(port_wd), "--max-epochs", "0",
                             *_opts(files, f"model.model_cfgs.gan_ckpt={files['gan']}")])
    runner.state = load_jax_checkpoint(raw, runner.state)
    assert runner.step == 2
    for h in HEADS:
        got = to_flax_params(getattr(runner.net, h))
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(params[h])):
            np.testing.assert_array_equal(a, np.asarray(b))
        opt = runner.optimizers[h]
        assert opt.count == 2 and {int(s["step"]) for s in opt.adam.state.values()} == {2}
    for k, m in (("gan_params", runner.framework.generator),
                 ("disc_params", runner.framework.discriminator)):
        got = jax.tree_util.tree_leaves(to_flax_params(m))
        assert all(np.array_equal(a, np.asarray(b)) for a, b in
                   zip(got, jax.tree_util.tree_leaves(raw["model_state"][k])))
    for k in ("center_w", "center_h"):
        np.testing.assert_array_equal(runner.model_state[k].numpy(), raw["model_state"][k])

    # one port step of step 1 and of step 2 against optax from the loaded state
    dev = runner.framework.batch_to_device(dict(batch, input_mask=np.ones((1, 32, 32, 1),
                                                                          np.float32)))
    b2 = dict(dev, **runner._collect_canon(dev))
    for mode, b in (("step1", dev), ("step2", b2)):
        before = {h: _np(to_flax_params(getattr(runner.net, h))) for h in HEADS}
        runner.train_step(mode, b)
        grads = _np(to_flax_grads(runner.net))
        for h in ("depth_head",) if mode == "step1" else ("encoder_head",):
            upd, opt_state[h] = tx.update(grads[h], opt_state[h], before[h])
            want = optax.apply_updates(before[h], upd)
            got = _np(to_flax_params(getattr(runner.net, h)))
            for a, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
                np.testing.assert_allclose(a, np.asarray(w), atol=1e-8, rtol=1.2e-7,
                                           err_msg=f"{mode} {h}")

    save_checkpoint(str(port_wd), runner.state, meta=load_meta(path))
    resumed = train_cli.main(
        [CONFIG, "--work-dir", str(port_wd), "--resume-from", "auto", "--max-epochs", "2",
         *_opts(files, f"model.model_cfgs.gan_ckpt={files['gan']}")])
    assert (resumed.epoch, resumed.step) == (2, 4 + 12)
