"""The port's runtime hooks, mixed precision and inference helpers against
the JAX package's (``runners/hooks.py`` EvalHook/ClosureHook,
``runners/hooks_extra.py``, ``runners/amp.py``, ``runners/forward_engine.py``,
``runners/inferencer.py``).

The hooks run on a stand-in runner that has what they read (epoch, iter,
log buffer, val, state), one per side, driven through the same epochs and
values.  The JAX side's checkpoint writes are recorded instead of made.
"""
import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import deep3dmap_tpu.runners.checkpoint as jax_ckpt
import deep3dmap_tpu.runners.hooks as jax_hooks
import deep3dmap_tpu.runners.hooks_extra as jax_extra
import deep3dmap_tpu_torch.runners.checkpoint as port_ckpt
from deep3dmap_tpu.utils.log_buffer import LogBuffer as JaxLogBuffer
from deep3dmap_tpu_torch.runners import amp, hooks, hooks_extra
from deep3dmap_tpu_torch.runners.train_state import TrainState
from deep3dmap_tpu_torch.utils.log_buffer import LogBuffer


class _Runner:
    """What the hooks read of a runner.  ``val_values[epoch]`` is what
    ``val`` logs as ``val_loss`` (a tensor on the port's side)."""

    def __init__(self, buffer, work_dir, val_values, state=None, tensor=False):
        self.log_buffer = buffer
        self.work_dir = str(work_dir)
        self.logger = logging.getLogger("test_torch_hooks_extra")
        self.epoch = self.iter = self.inner_iter = 0
        self.val_fn = object()
        self.val_values = val_values
        self.state = state
        self.tensor = tensor
        self._hooks = []
        self._max_epochs = 10
        self.cur_loader = None

    def call_hook(self, name):
        for h in self._hooks:
            getattr(h, name)(self)

    def val(self):
        self.call_hook("before_val_epoch")
        v = self.val_values[self.iter if self.val_by_iter else self.epoch]
        self.log_buffer.update({"val_loss": torch.tensor(v) if self.tensor else v})
        self.call_hook("after_val_epoch")

    val_by_iter = False


def _port_state():
    net = torch.nn.Linear(2, 1)
    from deep3dmap_tpu_torch.runners.optim import build_optimizer
    return TrainState(net=net, model_state={}, optimizer=build_optimizer(
        dict(type="Adam", lr=1e-3), net.parameters()))


def _drive(runner, by_epoch, n):
    for k in range(n):
        if by_epoch:
            runner.epoch = k
            runner.call_hook("after_train_epoch")
        else:
            runner.iter = k
            runner.call_hook("after_train_iter")


VALS = [3.0, 2.0, 2.5, 1.0, 1.5, 0.5]


@pytest.mark.parametrize("rule", ["less", "greater"])
@pytest.mark.parametrize("by_epoch", [True, False], ids=["by_epoch", "by_iter"])
@pytest.mark.parametrize("start", [None, 3])
def test_eval_hook_save_best_matches_jax(tmp_path, monkeypatch, rule, by_epoch, start):
    saved = {"jax": [], "port": []}
    monkeypatch.setattr(jax_ckpt, "save_checkpoint", lambda d, s, meta=None:
                        saved["jax"].append((os.path.relpath(d, tmp_path / "jax"),
                                             meta["best"])) or d)
    real = port_ckpt.save_checkpoint
    monkeypatch.setattr(port_ckpt, "save_checkpoint", lambda d, s, meta=None: (
        saved["port"].append((os.path.relpath(d, tmp_path / "port"), meta["best"]))
        or real(d, s, meta=meta)))
    runs = {}
    for side, mod, buf in (("jax", jax_hooks, JaxLogBuffer()), ("port", hooks, LogBuffer())):
        r = _Runner(buf, tmp_path / side, VALS, state=_port_state() if side == "port" else None,
                    tensor=side == "port")
        r.val_by_iter = not by_epoch
        hook = mod.EvalHook(interval=1, by_epoch=by_epoch, start=start, save_best="loss",
                            rule=rule)
        r._hooks = [hook]
        _drive(r, by_epoch, len(VALS))
        runs[side] = hook.best
    assert [d for d, _ in saved["port"]] == [d for d, _ in saved["jax"]] and saved["port"]
    assert [b for _, b in saved["port"]] == pytest.approx([b for _, b in saved["jax"]])
    assert runs["port"] == pytest.approx(runs["jax"])
    # nothing clears the buffer here (no text logger), so each evaluation
    # reads the mean of every value logged so far
    logged = [v for i, v in enumerate(VALS) if start is None or i + 1 >= start]
    means = [np.float32(np.mean(np.float32(logged[:k + 1]))) for k in range(len(logged))]
    assert runs["port"] == pytest.approx(min(means) if rule == "less" else max(means))
    assert os.path.exists(os.path.join(tmp_path, "port", "best", "checkpoints", "latest"))


def test_eval_hook_interval_and_text_logger(tmp_path, monkeypatch):
    """Every second epoch; with a TextLoggerHook registered the port still
    saves (it reads at its own ``after_val_epoch``), where JAX's reads an
    emptied buffer and saves nothing."""
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jax_ckpt, "save_checkpoint",
                        lambda d, s, meta=None: calls["jax"].append(meta["best"]) or d)
    monkeypatch.setattr(port_ckpt, "save_checkpoint",
                        lambda d, s, meta=None: calls["port"].append(meta["best"]) or d)
    for side, mod, buf in (("jax", jax_hooks, JaxLogBuffer()), ("port", hooks, LogBuffer())):
        r = _Runner(buf, tmp_path / side, VALS)
        r._hooks = [mod.EvalHook(interval=2, save_best="loss"), mod.TextLoggerHook(json_log=False)]
        _drive(r, True, len(VALS))
    assert calls == {"jax": [], "port": [2.0, 1.0, 0.5]}


def test_closure_hook():
    seen = []
    for mod in (jax_hooks, hooks):
        h = mod.ClosureHook("after_train_epoch", lambda runner: seen.append(runner))
        h.after_train_epoch("r")
    assert seen == ["r", "r"]
    with pytest.raises(ValueError):
        hooks.ClosureHook("not_a_stage", print)


def test_ema_hook_matches_jax():
    rs = np.random.RandomState(0)
    net = torch.nn.Linear(3, 2)
    jparams = {"w": jnp.asarray(net.weight.detach().numpy().copy()),
               "b": jnp.asarray(net.bias.detach().numpy().copy())}
    from deep3dmap_tpu.runners.train_state import TrainState as JaxTrainState
    jr = _Runner(JaxLogBuffer(), ".", [])
    jr.state = JaxTrainState.create(jax.random.PRNGKey(0), jparams, optax.sgd(0.1), {})
    pr = _Runner(LogBuffer(), ".", [], state=TrainState(net=net, model_state={}, optimizer=None))
    jh = jax_extra.EMAHook(momentum=0.3, interval=2, warm_up=3)
    ph = hooks_extra.EMAHook(momentum=0.3, interval=2, warm_up=3)
    jh.before_run(jr)
    ph.before_run(pr)
    for it in range(9):
        w = rs.randn(2, 3).astype(np.float32)
        b = rs.randn(2).astype(np.float32)
        jr.state = jr.state.replace(params={"w": jnp.asarray(w), "b": jnp.asarray(b)})
        with torch.no_grad():
            net.weight.copy_(torch.from_numpy(w))
            net.bias.copy_(torch.from_numpy(b))
        jr.iter = pr.iter = it
        jh.after_train_iter(jr)
        ph.after_train_iter(pr)
        np.testing.assert_allclose(pr.ema_params[0].numpy(), np.asarray(jr.ema_params["w"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(pr.ema_params[1].numpy(), np.asarray(jr.ema_params["b"]),
                                   rtol=1e-6, atol=1e-7)
    live = net.weight.detach().clone()
    ph.before_val_epoch(pr)
    torch.testing.assert_close(net.weight.detach(), pr.ema_params[0], rtol=0, atol=0)
    ph.after_val_epoch(pr)
    torch.testing.assert_close(net.weight.detach(), live, rtol=0, atol=0)


def test_early_stopping_matches_jax():
    losses = [1.0, 0.8, 0.85, 0.81, 0.79, 0.9, 0.95]
    stops = []
    for mod, buf in ((jax_extra, JaxLogBuffer()), (hooks_extra, LogBuffer())):
        r = _Runner(buf, ".", [])
        h = mod.EarlyStoppingHook(monitor="loss", patience=2, min_delta=0.05)
        for e, v in enumerate(losses):
            r.epoch = e
            buf.clear()
            buf.update({"loss": torch.tensor(v) if buf.__class__ is LogBuffer else v})
            h.after_train_epoch(r)
            if r._max_epochs == r.epoch:
                break
        stops.append((r.epoch, h.best, h.wait))
    assert stops[0] == pytest.approx(stops[1]) and stops[0][0] == 3


def test_heartbeat_hook(tmp_path):
    path = str(tmp_path / "hb.json")
    r = _Runner(LogBuffer(), tmp_path, [])
    h = hooks_extra.HeartbeatHook(path, interval=3)
    h.before_run(r)
    assert json.load(open(path))["iter"] == 0
    for it in range(5):
        r.iter = it
        h.after_train_iter(r)
    beat = json.load(open(path))
    assert beat["iter"] == 2 and beat["epoch"] == 0 and beat["time"] > 0
    r.epoch = 1
    h.after_run(r)
    assert json.load(open(path))["epoch"] == 1 and not os.path.exists(path + ".tmp")


def test_profiler_hook_writes_a_trace(tmp_path):
    r = _Runner(LogBuffer(), tmp_path, [])
    h = hooks_extra.ProfilerHook(start_iter=1, n_iters=2)
    x = torch.randn(64, 64)
    for it in range(4):
        r.iter = it
        h.before_train_iter(r)
        torch.mm(x, x)
        h.after_train_iter(r)
    assert h.trace_path == str(tmp_path / "profile" / "trace_1_2.json")
    events = json.load(open(h.trace_path))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


@pytest.mark.parametrize("cls,pkg", [
    ("TensorboardLoggerHook", "torch.utils.tensorboard"), ("WandbLoggerHook", "wandb"),
    ("MlflowLoggerHook", "mlflow"), ("NeptuneLoggerHook", "neptune"),
    ("PaviLoggerHook", "pavi"), ("DvcliveLoggerHook", "dvclive")])
def test_logger_hooks_disabled_with_a_warning(tmp_path, monkeypatch, caplog, cls, pkg):
    monkeypatch.setitem(sys.modules, pkg, None)     # the client is not installed
    r = _Runner(LogBuffer(), tmp_path, [])
    h = getattr(hooks_extra, cls)()
    with caplog.at_level("WARNING"):
        h.before_run(r)
    assert f"{cls} disabled" in caplog.text
    r.iter = 49
    r.log_buffer.update({"loss": torch.tensor(1.0)})
    h.after_train_iter(r)           # a no-op, not an error
    h.after_run(r)


def test_shims_and_cheap_hooks(tmp_path):
    for name in ("OptimizerHook", "MultiOptimizerHook", "SyncBuffersHook", "EmptyCacheHook",
                 "DistSamplerSeedHook"):
        h = hooks.build_hook(dict(type=name))
        assert type(h).__name__ == name
    g = hooks.build_hook(dict(type="GradientCumulativeOptimizerHook", cumulative_iters=4,
                              grad_clip=dict(max_norm=1.0)))
    assert g.cumulative_iters == 4 and g.grad_clip == dict(max_norm=1.0)

    class _Loader:
        epoch = 0
    r = _Runner(LogBuffer(), tmp_path, [])
    r.cur_loader, r.epoch = _Loader(), 5
    hooks_extra.DistSamplerSeedHook().before_train_epoch(r)
    hooks_extra.EmptyCacheHook().after_train_epoch(r)
    assert r.cur_loader.epoch == 5


# ------------------------------------------------------------------ amp --
def _toy(rs):
    return {"dense": {"kernel": rs.randn(256, 128).astype(np.float32),
                      "bias": np.zeros(128, np.float32)},
            "head": {"kernel": rs.randn(128, 8).astype(np.float32)}}


def test_amp_loss_runs_bf16_keeps_fp32_master():
    from deep3dmap_tpu.runners.amp import amp_loss as jax_amp_loss

    host = _toy(np.random.RandomState(0))
    x = np.random.RandomState(3).randn(4, 256).astype(np.float32)
    seen = {}

    def jloss(p, xb):
        h = xb @ p["dense"]["kernel"] + p["dense"]["bias"]
        return jnp.sum(h * h)

    def tloss(p, xb):
        seen["dtype"] = p["dense"]["kernel"].dtype
        h = xb @ p["dense"]["kernel"] + p["dense"]["bias"]
        return torch.sum(h * h)

    jl, jg = jax.value_and_grad(jax_amp_loss(jloss))(
        jax.tree_util.tree_map(jnp.asarray, host), jnp.asarray(x))
    params = {k: {n: torch.tensor(v, requires_grad=True) for n, v in d.items()}
              for k, d in host.items()}
    loss = amp.amp_loss(tloss)(params, torch.from_numpy(x))
    loss.backward()
    assert seen["dtype"] == torch.bfloat16 and loss.dtype == torch.float32
    assert params["dense"]["kernel"].grad.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-2)
    fp32 = float(tloss(jax.tree_util.tree_map(torch.from_numpy, host), torch.from_numpy(x)))
    assert abs(float(loss) - fp32) / fp32 < 0.05
    g, w = params["dense"]["kernel"].grad.numpy(), np.asarray(jg["dense"]["kernel"])
    assert np.linalg.norm(g - w) / np.linalg.norm(w) < 2e-2


def test_amp_loss_scale_roundtrip():
    w = torch.tensor([2.0, 3.0], requires_grad=True)
    scaled = amp.amp_loss(lambda p: torch.sum(p["w"] ** 2), compute_dtype=torch.float32,
                          loss_scale=128.0)
    loss = scaled({"w": w})
    loss.backward()
    assert float(loss) == pytest.approx(128.0 * 13.0)
    grads = amp.unscale_grads({"w": w.grad}, 128.0)
    np.testing.assert_allclose(grads["w"].numpy(), [4.0, 6.0], rtol=1e-6)
    ok = amp.grads_finite(grads)
    assert ok.dtype == torch.bool and ok.shape == () and bool(ok)
    assert not bool(amp.grads_finite({"w": torch.tensor([float("nan"), 1.0])}))
    assert amp.unscale_grads(grads, None) is grads


def test_cast_floating_skips_ints():
    out = amp.cast_floating({"f": torch.ones(3), "i": torch.ones(3, dtype=torch.int32),
                             "s": "meta"}, torch.bfloat16)
    assert out["f"].dtype == torch.bfloat16 and out["i"].dtype == torch.int32
    assert out["s"] == "meta"


# ---------------------------------------------------------- inference --
class _ToyFramework:
    """forward_test: out = x @ w + state, state + 1 (on both sides)."""

    def __init__(self, xp):
        self.xp = xp

    def forward_test(self, params, state, batch):
        out = {"y": batch["x"] @ params + state}
        return out, state + 1


def test_forward_test_loop_matches_jax():
    from deep3dmap_tpu.parallel.mesh import make_mesh
    from deep3dmap_tpu.runners.forward_engine import forward_test_loop as jax_loop
    from deep3dmap_tpu_torch.runners.forward_engine import collect_results, forward_test_loop

    rs = np.random.RandomState(0)
    w = rs.randn(3, 2).astype(np.float32)
    batches = [{"x": rs.randn(8, 3).astype(np.float32)} for _ in range(3)]
    j = jax_loop(_ToyFramework(jnp), jnp.asarray(w), jnp.float32(0.0), batches,
                 make_mesh(), progress=False)
    t = forward_test_loop(_ToyFramework(torch), torch.from_numpy(w), torch.tensor(0.0),
                          [{"x": torch.from_numpy(b["x"])} for b in batches], progress=False)
    assert len(t["y"]) == len(j["y"]) == 3
    for a, b in zip(t["y"], j["y"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert collect_results(t) is t


def test_base_inferencer_matches_jax(tmp_path):
    """NeuralRecon's dense config: JAX's inferencer on its orbax checkpoint
    and the port's on its own checkpoint of the same weights, two
    fragments with the state carried."""
    from deep3dmap_tpu.runners.checkpoint import save_checkpoint as jax_save
    from deep3dmap_tpu.runners.inferencer import BaseInferencer as JaxInferencer
    from deep3dmap_tpu.runners.train_state import TrainState as JaxTrainState
    from deep3dmap_tpu_torch.runners.inferencer import BaseInferencer
    from torch_slice_helpers import build_pair, two_fragments

    cfg = dict(N_LAYER=3, N_VOX=[24, 24, 24], VOXEL_SIZE=0.08,
               FUSION=dict(FUSION_ON=True, FULL=True), BACKBONE2D=dict(ARC="fpn-mnas-0.5"))
    frags = two_fragments(n_views=2, n_vox=24)
    jfw, params, tfw = build_pair(cfg, frags)
    jstate = JaxTrainState.create(jax.random.PRNGKey(0), params, optax.adam(1e-3),
                                  jfw.init(jax.random.PRNGKey(0), frags[0])[1])
    jpath = jax_save(str(tmp_path / "jax"), jstate)
    ppath = port_ckpt.save_checkpoint(str(tmp_path / "port"), TrainState(
        net=tfw.net, model_state=tfw.init_state(2), optimizer=_port_state().optimizer))
    model = {"model": dict(type="NeuralRecon", model_cfgs=cfg)}
    ji = JaxInferencer(model, checkpoint=jpath)
    ti = BaseInferencer(model, checkpoint=ppath, device="cpu")
    for frag in frags:
        j, t = ji(frag), ti(frag)
        assert sorted(j) == sorted(t)
        for k in ("tsdf", "occ", "origin"):
            assert t[k].dtype == np.float32
            np.testing.assert_allclose(t[k], np.asarray(j[k], np.float32), atol=2e-3, rtol=0,
                                       err_msg=k)
