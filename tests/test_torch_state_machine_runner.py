"""``StateMachineRunner`` in the port against the JAX package's, on the CPU.

- The states per epoch equal JAX's runner's through ``run`` (a three-state
  sequence switched by epoch, and a two-state one switched by iteration),
  the switch logged and handed to the framework.
- The multi-sequence path on a toy framework with two parameter
  collections: in state ``A`` only ``netA`` moves (``netB`` bitwise), in
  ``AB`` each sequence's step updates its collection alone; the logs carry
  JAX's ``{opt_seq}_{key}`` tags and values (1e-6) and the collections end
  where JAX's do.
- ``configs/pt3d_demos/imgs2face_synthetic.py``'s model and data: 4 Adam
  steps across the switch (2 in ``sup``, 2 in ``sup_unsup``) against JAX's
  runner, each from JAX's state before it, its loss within 1e-4 relative
  (each log var also within 1e-4 of the step's loss); stepping freely from the same weights, the two steps
  before the switch within 1e-4 (after it the curves part: Adam's
  sign-driven updates of near-zero gradients, measured in the test).
- That JAX run's checkpoint (orbax, ``opt_state`` keyed by collection)
  loads into the port's runner built by the train CLI (params and Adam
  state exactly), and, saved as the port's checkpoint, resumes through the
  CLI in JAX's state.
"""
import os.path as osp

import numpy as np
import pytest
import torch

import flax.linen as jnn
import jax
import jax.numpy as jnp

from deep3dmap_tpu.datasets.builder import NumpyLoader as JLoader
from deep3dmap_tpu.datasets.face_tuple import SyntheticFaceTupleDataset as JDataset
from deep3dmap_tpu.models.frameworks import imgs2mesh as JI
from deep3dmap_tpu.parallel import make_mesh
from deep3dmap_tpu.runners import hooks as jhooks
from deep3dmap_tpu.runners.checkpoint import load_checkpoint_raw as jax_load_raw
from deep3dmap_tpu.runners.checkpoint import save_checkpoint as jax_save_checkpoint
from deep3dmap_tpu.runners.state_machine_runner import StateMachineRunner as JRunner
from deep3dmap_tpu.utils.config import Config as JaxConfig
from deep3dmap_tpu_torch.datasets.builder import NumpyLoader
from deep3dmap_tpu_torch.models.frameworks import imgs2mesh as TI
from deep3dmap_tpu_torch.models.layers import Dense, init_flax_defaults
from deep3dmap_tpu_torch.runners import hooks as thooks
from deep3dmap_tpu_torch.runners.builder import build_runner
from deep3dmap_tpu_torch.runners.checkpoint import latest_checkpoint, load_meta, save_checkpoint
from deep3dmap_tpu_torch.tools import train as train_cli
from deep3dmap_tpu_torch.utils.from_flax import (load_flax_params, load_jax_checkpoint,
                                                 to_flax_adam_state, to_flax_params)

torch.set_num_threads(2)
ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG = osp.join(ROOT, "configs", "pt3d_demos", "imgs2face_synthetic.py")
LOSS_RTOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _mesh():
    return make_mesh(devices=jax.devices()[:1])


# -- a toy framework with two collections, on both sides ------------------------
class JToy:
    is_multi_opt_iters = True

    def __init__(self):
        self.a, self.b = jnn.Dense(4), jnn.Dense(1)

    def init(self, rng, batch):
        ka, kb = jax.random.split(rng)
        pa = self.a.init(ka, batch["x"])["params"]
        pb = self.b.init(kb, jnp.zeros((batch["x"].shape[0], 4)))["params"]
        return {"netA": pa, "netB": pb}, {}

    def setup_optimize_sequences(self, state):
        return list(state)

    def optseq2netnames(self, opt_seq):
        return ["net" + opt_seq]

    def on_state_switch(self, state):
        self.switched = getattr(self, "switched", []) + [state]

    def loss_fn(self, params, mstate, batch, rng, state=None, opt_seq=None):
        h = jnp.tanh(self.a.apply({"params": params["netA"]}, batch["x"]))
        mse = jnp.mean((self.b.apply({"params": params["netB"]}, h) - batch["y"]) ** 2)
        return mse, {"log_vars": {"mse": mse}, "model_state": mstate}


class TToy:
    is_multi_opt_iters = True
    network_names = ["netA", "netB"]
    device = torch.device("cpu")

    def init(self, seed, batch):
        net = torch.nn.Module()
        net.netA, net.netB = Dense(3, 4), Dense(4, 1)
        init_flax_defaults(net, torch.Generator().manual_seed(seed))
        return net, {}

    def setup_optimize_sequences(self, state):
        return list(state)

    def optseq2netnames(self, opt_seq):
        return ["net" + opt_seq]

    def on_state_switch(self, state):
        self.switched = getattr(self, "switched", []) + [state]

    def loss_fn(self, net, mstate, batch, rng=None, state=None, opt_seq=None):
        x, y = (torch.as_tensor(batch[k]) for k in ("x", "y"))
        mse = torch.mean((net.netB(torch.tanh(net.netA(x))) - y) ** 2)
        return mse, {"log_vars": {"mse": mse}, "model_state": mstate}


def _toy_data(n):
    rs = np.random.RandomState(0)
    return [dict(x=rs.randn(3).astype(np.float32), y=rs.randn(1).astype(np.float32))
            for _ in range(n)]


def _recorder(base):
    class Record(base):
        def __init__(self):
            self.seen = []

        def before_train_epoch(self, runner):
            self.seen.append((runner.epoch, runner.iter, runner.cur_state))
    return Record()


@pytest.mark.parametrize("by,seq,steps,epochs,n", [
    ("epoch", ["A", "AB", "B"], [0, 2, 3], 5, 2),
    ("iter", ["A", "AB"], [0, 3], 4, 4)])
def test_state_sequence_matches_jax(tmp_path, by, seq, steps, epochs, n):
    data = _toy_data(n)
    kw = dict(state_seq=seq, state_steps=steps, state_switch_by=by, max_epochs=epochs)
    jr = JRunner(JToy(), work_dir=str(tmp_path / "jax"), mesh=_mesh(), **kw)
    jrec = _recorder(jhooks.Hook)
    jr.register_hook(jrec)
    jloader = JLoader(data, batch_size=2)
    jr.setup(next(iter(jloader)), optimizer=dict(type="Adam", lr=1e-2))
    jr.run([jloader], [("train", 1)])

    tr = build_runner(dict(type="StateMachineRunner", **kw),
                      default_args=dict(framework=TToy(), work_dir=str(tmp_path / "port")))
    trec = _recorder(thooks.Hook)
    tr.register_hook(trec)
    loader = NumpyLoader(data, batch_size=2)
    tr.setup(next(iter(loader)), optimizer=dict(type="Adam", lr=1e-2))
    tr.run([loader], [("train", 1)])
    assert trec.seen == jrec.seen and len(set(s for *_, s in trec.seen)) == len(seq)
    assert tr.framework.switched == jr.framework.switched
    assert (tr.epoch, tr.iter, tr.cur_state) == (jr.epoch, jr.iter, jr.cur_state)


def test_multi_sequences_step_only_their_collection(tmp_path):
    batch = JLoader(_toy_data(4), batch_size=4).__iter__().__next__()
    jr = JRunner(JToy(), work_dir=str(tmp_path / "jax"), mesh=_mesh(),
                 state_seq=["A", "AB"], state_steps=[0, 1])
    jr.setup(batch, optimizer=dict(type="Adam", lr=1e-2))
    tr = build_runner(dict(type="StateMachineRunner", state_seq=["A", "AB"],
                           state_steps=[0, 1]), default_args=dict(framework=TToy()))
    net, _ = tr.setup(batch, optimizer=dict(type="Adam", lr=1e-2)).net, None
    load_flax_params(net, _np(jr.state.params))
    assert set(tr.state.optimizer) == {"netA", "netB"}

    for epoch in (0, 1, 1):
        jr.epoch = tr.epoch = epoch
        jr.state_switch()
        tr.state_switch()
        before = {k: v.clone() for k, v in net.state_dict().items()}
        jr.log_buffer.clear()
        jr.run_multi_iter(batch)
        logs = tr.run_multi_iter(batch)
        want = {k: v[-1] for k, v in jr.log_buffer.val_history.items()}
        assert list(logs) == list(want)
        assert list(logs) == (["A_loss", "A_mse"] if epoch == 0 else
                              ["A_loss", "A_mse", "B_loss", "B_mse"])
        for k, v in logs.items():
            np.testing.assert_allclose(float(v), want[k], rtol=1e-6, err_msg=k)
        moved = {k: not torch.equal(v, before[k]) for k, v in net.state_dict().items()}
        assert all(moved[k] == (epoch == 1 or k.startswith("netA.")) for k in moved), moved
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(to_flax_params(net)),
                                jax.tree_util.tree_leaves(_np(jr.state.params))):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=str(path))
    assert [o.count for o in tr.state.optimizer.values()] == [3, 2]


# -- imgs2mesh across the switch ---------------------------------------------------
@pytest.fixture(scope="module")
def jax_curve(tmp_path_factory):
    """JAX's runner on the config's model and data: 4 steps on one batch,
    epochs 0-3 (the switch to sup_unsup at 2), its state saved before each
    step and after the last."""
    cfg = JaxConfig.fromfile(CONFIG)
    data = {k: v for k, v in cfg.data["train"].items() if k != "type"}
    batch = next(iter(JLoader(JDataset(**data), batch_size=cfg.data["samples_per_gpu"])))
    runner = dict(cfg.runner)
    wd = str(tmp_path_factory.mktemp("smr_jax"))
    jr = JRunner(JI.Imgs2Mesh(cfg.model["model_cfgs"]), work_dir=wd, mesh=_mesh(),
                 runner_cfgs=dict(runner["runner_cfgs"]), state_seq=runner["state_seq"],
                 state_steps=runner["state_steps"])
    jr.setup(batch, optimizer=runner["runner_cfgs"]["optimizer"])
    params0 = _np(jr.state.params)
    steps = []
    for epoch in range(4):
        jr.epoch = jr.iter = epoch
        jr.state_switch()
        before = jax_save_checkpoint(wd, jr.state, meta=dict(epoch=epoch, iter=epoch))
        logs = jr.run_iter(batch)
        steps.append(dict(state=jr.cur_state, before=before, params=_np(jr.state.params),
                          logs={k: float(v) for k, v in logs.items()}))
    path = jax_save_checkpoint(wd, jr.state, meta=dict(epoch=4, iter=4))
    return dict(batch=batch, params0=params0, steps=steps, path=path, cur_state=jr.cur_state,
                params=_np(jr.state.params), opt_state=jr.state.opt_state,
                lr=runner["runner_cfgs"]["optimizer"]["lr"])


def _port_runner(tmp_path):
    cfg = JaxConfig.fromfile(CONFIG)
    runner = dict(cfg.runner)
    tr = build_runner(dict(type="StateMachineRunner", state_seq=runner["state_seq"],
                           state_steps=runner["state_steps"]),
                      default_args=dict(framework=TI.Imgs2Mesh(cfg.model["model_cfgs"],
                                                               device="cpu"),
                                        work_dir=str(tmp_path),
                                        runner_cfgs=dict(runner["runner_cfgs"])))
    return tr


def _check_logs(logs, want, msg):
    """The step's loss within 1e-4 relative; each log var within 1e-4 of
    itself plus 1e-4 of the step's loss.  ``scale_consistent_loss`` is
    2000 x |s_0 - s_1| over two nearly equal scales, so float32 rounding of
    the scales shows in it: 1.3e-4 of itself at the first ``sup_unsup``
    step, 4.8e-5 of the step's loss (the loss within 3.0e-5)."""
    assert set(logs) == set(want), msg
    np.testing.assert_allclose(float(logs["loss"]), want["loss"], rtol=LOSS_RTOL, err_msg=msg)
    for k, v in logs.items():
        np.testing.assert_allclose(float(v), want[k], rtol=LOSS_RTOL,
                                   atol=LOSS_RTOL * abs(want["loss"]), err_msg=f"{msg} {k}")


def test_each_step_across_the_switch_matches_jax(jax_curve, tmp_path):
    """Each of the 4 steps from JAX's state before it (params and Adam,
    through its checkpoint): the same state, the logs within 1e-4, and the
    parameters after it within 2 lr of JAX's (Adam moves a weight by about
    lr, in the direction of its gradient's sign)."""
    tr = _port_runner(tmp_path)
    tr.setup(jax_curve["batch"])
    assert list(tr.state.optimizer) == ["params"]
    for epoch, want in enumerate(jax_curve["steps"]):
        tr.state = load_jax_checkpoint(jax_load_raw(want["before"]), tr.state)
        tr.epoch = epoch
        tr.state_switch()
        assert tr.cur_state == tr.framework.state == want["state"]
        _check_logs(tr.run_iter(jax_curve["batch"]), want["logs"], f"step {epoch}")
        for a, b in zip(jax.tree_util.tree_leaves(to_flax_params(tr.state.net)),
                        jax.tree_util.tree_leaves(want["params"])):
            assert np.abs(a - b).max() <= 2 * jax_curve["lr"]
    assert [s["state"] for s in jax_curve["steps"]] == ["sup", "sup", "sup_unsup", "sup_unsup"]


def test_adam_curve_matches_jax_before_the_switch(jax_curve, tmp_path):
    """The runner stepping freely from JAX's init: the two ``sup`` steps
    within 1e-4 (measured 5.8e-6).  After the switch the curves part:
    Adam moves a weight whose gradient is near 0 by about lr either way,
    and the zero-initialised GroupNorm biases' gradients change sign under
    float32 rounding (measured per step: 1.9e-5 to 1.3e-4 at step 3, 1e-2 at
    step 4, with the losses of equal parameters within 3e-5; ROADMAP.md
    Queue 3)."""
    tr = _port_runner(tmp_path)
    tr.setup(jax_curve["batch"])
    load_flax_params(tr.state.net, jax_curve["params0"])
    for epoch, want in enumerate(jax_curve["steps"][:2]):
        tr.epoch = epoch
        tr.state_switch()
        _check_logs(tr.run_iter(jax_curve["batch"]), want["logs"], f"step {epoch}")


def test_jax_checkpoint_resumes_in_the_port(jax_curve, tmp_path):
    raw = jax_load_raw(jax_curve["path"])
    assert set(raw["opt_state"]) == {"params"}
    wd = str(tmp_path / "port")
    runner = train_cli.main([CONFIG, "--work-dir", wd, "--max-epochs", "0", "--device", "cpu"])
    runner.state = load_jax_checkpoint(raw, runner.state)
    assert runner.state.step == 4
    net = runner.state.net
    for a, b in zip(jax.tree_util.tree_leaves(to_flax_params(net)),
                    jax.tree_util.tree_leaves(jax_curve["params"])):
        np.testing.assert_array_equal(a, b)
    opt = runner.state.optimizer["params"]
    got = to_flax_adam_state(net, opt.adam)
    want = jax_curve["opt_state"]["params"][0]
    assert got["count"] == int(want.count) == opt.count == 4
    for k in ("mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves(got[k]),
                        jax.tree_util.tree_leaves(_np(getattr(want, k)))):
            np.testing.assert_array_equal(a, b)

    save_checkpoint(wd, runner.state, meta=load_meta(jax_curve["path"]))
    resumed = train_cli.main([CONFIG, "--work-dir", wd, "--resume-from", "auto",
                              "--max-epochs", "5", "--device", "cpu"])
    assert resumed.cur_state == resumed.framework.state == jax_curve["cur_state"] == "sup_unsup"
    assert (resumed.epoch, resumed.state.step) == (5, 4 + 4)
    assert latest_checkpoint(wd).endswith("ckpt_8")
