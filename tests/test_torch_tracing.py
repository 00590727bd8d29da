"""The program's spans and counters (``deep3dmap_tpu_torch/utils/tracing.py``).

- With no profiler running, ``span`` is one shared null context and the
  registry keeps no tensor; Python ints are counted always.
- Under ``torch.profiler`` (CPU), a small NeuralRecon ``train_step`` in block
  and in dense mode records every span of the step's layers, nested as the
  step nests them; the trunk's span opens again in the backward when
  ``REMAT`` recomputes it; ``forward_test`` records the same model spans.
- The counters ``nr.l{i}.blocks`` and ``nr.l{i}.bp`` equal the active and
  kept counts computed directly from the selection's inputs and outputs.
- Losses, gradients, weights and state are bit-equal with tracing on and off.
"""
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deep3dmap_tpu_torch.datasets.builder import _stack_samples
from deep3dmap_tpu_torch.datasets.synthetic import make_fragment_sample
from deep3dmap_tpu_torch.models.frameworks import neuralrecon as torch_nr
from deep3dmap_tpu_torch.runners import train_state as ts
from deep3dmap_tpu_torch.runners.optim import build_optimizer
from deep3dmap_tpu_torch.utils import tracing

torch.set_num_threads(2)

COMMON = dict(N_LAYER=3, VOXEL_SIZE=0.08, FUSION=dict(FUSION_ON=True, FULL=True),
              LW=[1.0, 0.8, 0.64], THRESHOLDS=[0, 0, 0], POS_WEIGHT=1.5)
CFGS = {
    # levels 1-2 on active 8³ blocks, budgets of 4 and 24 blocks
    "block": (dict(COMMON, N_VOX=[32, 32, 32], TRAIN_NUM_SAMPLE=[64, 256],
                   SPARSE_MODE="block", BLOCK_SIZE=8, MAX_BLOCKS=[None, 4, 24]), 32),
    # dense levels, levels 1-2 back-projected at capacities under their dim³
    "dense": (dict(COMMON, N_VOX=[16, 16, 16], TRAIN_NUM_SAMPLE=[64, 128, 512]), 16),
}
STEP = ("step", "step.forward", "step.backward", "step.optimizer")
MODEL = ("nr.hidden_read", "nr.hidden_write", "nr.trunk")
LEVEL = ("backproject", "context", "net3d", "gru", "heads")


def _frame(mode, remat=True):
    cfg, n_vox = CFGS[mode]
    cfg = dict(cfg, BACKBONE2D=dict(ARC="fpn-mnas-0.5", MODE="batch", REMAT=remat))
    fw = torch_nr.NeuralRecon(cfg, device="cpu")
    fw.init(0, _batch(n_vox))
    return fw, n_vox


def _batch(n_vox, seed=0):
    b = _stack_samples([make_fragment_sample(seed=seed, n_views=2, img_size=(64, 64),
                                             n_vox=n_vox, voxel_size=0.08, device="cpu")])
    b["scene_reset"] = torch.ones(1)
    return b


def _state(fw):
    opt = build_optimizer(dict(type="Adam", lr=1e-3), fw.net.parameters(), dict(max_norm=1.0))
    return ts.TrainState(net=fw.net, optimizer=opt, model_state=fw.init_state(1))


def _profiled(fn):
    """``fn()`` under the profiler (CPU); returns its result and the span
    events as (name without the prefix, start_ns, end_ns, thread)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name()[len(tracing.PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns(),
              e.start_thread_id()) for e in prof.profiler.kineto_results.events()
             if e.name().startswith(tracing.PREFIX)]
    return out, spans


def _inside(child, parents):
    return any(p[3] == child[3] and p[1] <= child[1] and child[2] <= p[2] for p in parents)


def _assert_nested(spans, child, parent):
    kids = [s for s in spans if s[0] == child]
    dads = [s for s in spans if s[0] == parent]
    assert kids, f"no span {child}"
    assert all(_inside(k, dads) for k in kids), f"{child} outside {parent}"


def test_span_off_is_a_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = tracing.span("nr.trunk"), tracing.span("step")
    assert a is b and isinstance(a, contextlib.nullcontext)
    tracing.reset_counters("t.")
    tracing.count("t.blocks", torch.tensor([3, 9]), cap=4)
    assert tracing.read_counters("t.") == {} and "t.blocks" not in tracing._kept
    tracing.count("t.launches")
    tracing.count("t.launches", 2)
    assert tracing.counter("t.launches") == 3 and tracing.read_counters("t.") == {"t.launches": 3}
    tracing.reset_counters("t.")
    assert tracing.counter("t.launches") == 0


def test_counters_under_a_profiler():
    tracing.reset_counters("t.")
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("t.outer"):
            tracing.count("t.blocks", torch.tensor([3, 9]), cap=4)
            tracing.count("t.blocks", torch.tensor([5]), cap=4)
            tracing.count("t.rows", torch.tensor([2, 2]))
    assert tracing.read_counters("t.") == {
        "t.blocks.active": 17, "t.blocks.kept": 11, "t.blocks.slots": 12,
        "t.blocks.overflow": 6, "t.blocks.rows": 3, "t.rows": 4}
    tracing.reset_counters("t.")
    assert tracing.read_counters("t.") == {}


def test_profiler_hook_logs_the_traced_iterations_counts(tmp_path, caplog):
    """``ProfilerHook`` logs each counter's change over the iterations it
    traces: ints counted before it started, and tensors kept by an earlier
    profiler, are left out."""
    import logging
    import types

    from deep3dmap_tpu_torch.runners.hooks_extra import ProfilerHook

    tracing.reset_counters("t.")
    tracing.count("t.launches", 7)
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("t.blocks", torch.tensor([5]), cap=4)
    runner = types.SimpleNamespace(work_dir=str(tmp_path), iter=0,
                                   logger=logging.getLogger("test_torch_tracing"))
    hook = ProfilerHook(start_iter=1, n_iters=2)
    with caplog.at_level("INFO"):
        for it in range(4):
            runner.iter = it
            hook.before_train_iter(runner)
            tracing.count("t.launches")
            tracing.count("t.blocks", torch.tensor([3, 9]), cap=4)
            hook.after_train_iter(runner)
    logged = caplog.text.split("counters ", 1)[1]
    for want in ("'t.launches': 2", "'t.blocks.active': 24", "'t.blocks.kept': 14",
                 "'t.blocks.slots': 16", "'t.blocks.overflow': 10", "'t.blocks.rows': 4"):
        assert want in logged, logged
    tracing.reset_counters("t.")


@pytest.mark.parametrize("mode,remat", [("block", True), ("dense", True), ("dense", False)])
def test_train_step_records_the_layer_spans(mode, remat):
    fw, n_vox = _frame(mode, remat)
    state = _state(fw)
    batch = _batch(n_vox)
    _, spans = _profiled(lambda: ts.train_step(fw, state, batch))
    names = {s[0] for s in spans}
    levels = [f"nr.l{i}.{k}" for i in range(3) for k in LEVEL]
    selects = [f"nr.l{i}.select" for i in (1, 2)]
    want = set(STEP) | set(MODEL) | set(levels) | {"nr.loss"}
    if mode == "block":
        want |= set(selects) | {"block_sparse.gather_halo"}
    assert names == want, names ^ want
    for child in STEP[1:]:
        _assert_nested(spans, child, "step")
    for child in MODEL[:2] + ("nr.loss",) + tuple(levels) + (
            tuple(selects) if mode == "block" else ()):
        _assert_nested(spans, child, "step.forward")
    if mode == "block":
        halo = [s for s in spans if s[0] == "block_sparse.gather_halo"]
        hosts = [s for s in spans if s[0].endswith((".net3d", ".gru"))
                 and s[0][:5] in ("nr.l1", "nr.l2")]
        assert halo and all(_inside(h, hosts) for h in halo)
    trunk = [s for s in spans if s[0] == "nr.trunk"]
    fwd = [s for s in spans if s[0] == "step.forward"]
    bwd = [s for s in spans if s[0] == "step.backward"]
    assert sum(_inside(t, fwd) for t in trunk) == 1
    # the checkpointed trunk is recomputed, and its span opens, in the backward
    assert sum(_inside(t, bwd) for t in trunk) == (1 if remat else 0)
    assert len(trunk) == (2 if remat else 1)


def test_forward_test_records_the_model_spans():
    fw, n_vox = _frame("block")
    _, spans = _profiled(lambda: fw.forward_test(fw.net, fw.init_state(1), _batch(n_vox)))
    names = {s[0] for s in spans}
    assert set(MODEL) | {"block_sparse.gather_halo", "nr.l1.select", "nr.l2.heads"} <= names
    assert not any(n.startswith("step") for n in names) and "nr.loss" not in names


def test_grad_reduce_span_on_a_mesh(monkeypatch):
    """A framework with a ``loss_group`` reduces its gradients inside
    ``step.grad_reduce``, between the backward and the optimizer."""
    seen = []
    monkeypatch.setattr(ts, "reduce_gradients", lambda params, group: seen.append(group))

    class Toy:
        loss_group = "data"

        def loss_fn(self, net, model_state, batch):
            return net(batch).square().sum(), {"log_vars": {}, "model_state": model_state}

    net = torch.nn.Linear(3, 1)
    state = ts.TrainState(net=net, model_state={}, optimizer=build_optimizer(
        dict(type="Adam", lr=1e-3), net.parameters(), dict(max_norm=1.0)))
    _, spans = _profiled(lambda: ts.train_step(Toy(), state, torch.ones(2, 3)))
    assert seen == ["data"]
    _assert_nested(spans, "step.grad_reduce", "step")
    at = {s[0]: s for s in spans}
    assert at["step.backward"][2] <= at["step.grad_reduce"][1]
    assert at["step.grad_reduce"][2] <= at["step.optimizer"][1]


def _spy(monkeypatch, name, calls):
    orig = getattr(torch_nr, name)

    def spy(*a, **kw):
        out = orig(*a, **kw)
        calls.append((a, kw, out))
        return out
    monkeypatch.setattr(torch_nr, name, spy)


def test_block_counters_equal_the_selection(monkeypatch):
    fw, n_vox = _frame("block")
    calls = []
    _spy(monkeypatch, "select_blocks", calls)
    tracing.reset_counters("nr.")
    _profiled(lambda: ts.train_step(fw, _state(fw), _batch(n_vox)))
    got = tracing.read_counters("nr.")
    assert [kw["count_as"] for _, kw, _ in calls] == ["nr.l1.blocks", "nr.l2.blocks"]
    for (mask, maxb, _), kw, bset in calls:
        name = kw["count_as"]
        active = mask.reshape(mask.shape[0], -1).sum(1)
        assert got[f"{name}.active"] == int(active.sum())
        assert got[f"{name}.kept"] == int(bset.valid.sum())
        assert got[f"{name}.slots"] == maxb * mask.shape[0]
        assert got[f"{name}.overflow"] == int((active - maxb).clamp(min=0).sum())
    tracing.reset_counters("nr.")


def test_bp_counters_equal_the_active_voxels(monkeypatch):
    fw, n_vox = _frame("dense")
    calls = []
    _spy(monkeypatch, "back_project_masked_batch", calls)
    tracing.reset_counters("nr.")
    _profiled(lambda: ts.train_step(fw, _state(fw), _batch(n_vox)))
    got = tracing.read_counters("nr.")
    assert [kw["count_as"] for _, kw, _ in calls] == ["nr.l1.bp", "nr.l2.bp"]
    for a, kw, _ in calls:
        mask, cap = a[3], a[4]
        n_active = mask.reshape(mask.shape[0], -1).sum(1)
        name = kw["count_as"]
        assert got[f"{name}.active"] == int(n_active.sum())
        assert got[f"{name}.kept"] == int(n_active.clamp(max=cap).sum())
        assert got[f"{name}.slots"] == cap * mask.shape[0]
    tracing.reset_counters("nr.")


@pytest.mark.parametrize("mode", sorted(CFGS))
def test_tracing_changes_no_number(mode):
    """Two steps from the same weights and state, with the profiler and its
    spans and counters on and with them off: everything bit-equal."""
    runs = []
    for on in (False, True):
        fw, n_vox = _frame(mode)
        state = _state(fw)
        logs = []

        def steps():
            nonlocal state
            for k in range(2):
                state, log = ts.train_step(fw, state, _batch(n_vox, seed=k))
                logs.append(log)
        if on:
            _profiled(steps)
        else:
            steps()
        runs.append(dict(
            logs=[{k: v.clone() for k, v in log.items()} for log in logs],
            grads=[p.grad.clone() for p in fw.net.parameters()],
            params=[p.detach().clone() for p in fw.net.parameters()],
            volumes=[v.clone() for v in state.model_state["global_hidden"].volumes]))
    off, on = runs
    assert off["logs"][0].keys() == on["logs"][0].keys()
    for a, b in zip(off["logs"], on["logs"]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for key in ("grads", "params", "volumes"):
        assert all(torch.equal(x, y) for x, y in zip(off[key], on[key])), key
    tracing.reset_counters("nr.")
