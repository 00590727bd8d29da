"""The port's training runtime optimizers (``runners/optim.py``) against the
JAX package's ``runners/optim.py`` and optax 0.2.6.

* every lr policy x ``by_epoch`` x warmup kind against JAX's
  ``build_lr_schedule`` over ``total_iters + 2`` steps, each step an int32
  scalar as optax's count is: equal bit for bit where only ``+ - * /``,
  ``min`` and ``where`` occur, within 4 float32 eps x base_lr where ``cos``
  or ``pow`` does (XLA's float32 ``cos``/``pow`` are its own).  The
  schedule is evaluated op by op: XLA's fused CPU code divides by a
  constant through its reciprocal and contracts the multiply-add, so a
  jitted JAX schedule moves by an ulp from its own op-by-op values (and
  ``poly`` at ``step >= total_iters`` takes a power of -3e-8: NaN);
* each optimizer of JAX's factory for 5 steps on the same fed gradients,
  with the clip and a schedule: parameters and optax's state buffers
  (moments, traces, accumulators) after every step, leaf by leaf, to 1e-6
  relative (the same float32 formulas, some in another order);
* paramwise multipliers leaf by leaf on a small NeuralRecon tree against
  JAX's transforms' own trees, and a 3-step curve of AdamW + paramwise;
* MultiSteps (k = 2 and 3) with the clip and a schedule over 7 steps;
* a JAX checkpoint of AdamW + paramwise + MultiSteps, saved mid-window,
  resumed in the port and stepped on beside JAX.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deep3dmap_tpu.runners import optim as jax_optim
from deep3dmap_tpu_torch.models.layers import Conv, Dense, GroupNorm
from deep3dmap_tpu_torch.runners import optim
from deep3dmap_tpu_torch.runners.train_state import TrainState
from deep3dmap_tpu_torch.utils.from_flax import (_leaf_map, _state_dicts, _to_flax_tree,
                                                 load_jax_checkpoint, to_flax_adam_state,
                                                 to_flax_grads, to_flax_params)
from torch_slice_helpers import leaf_rel_errors

RTOL = 1e-6
EPS32 = float(np.finfo(np.float32).eps)
BASE_LR, TOTAL, IPE = 1e-2, 12, 3

# policy -> (kwargs, whether cos or pow occurs)
POLICIES = {
    "fixed": (dict(), False),
    "step": (dict(step=[1, 3], gamma=0.5), False),
    "exp": (dict(gamma=0.9), True),
    "poly": (dict(power=0.9, min_lr=1e-4), True),
    "inv": (dict(gamma=0.5, power=0.75), True),
    "cosineannealing": (dict(min_lr_ratio=0.05), True),
    "flatcosineannealing": (dict(start_percent=0.5, min_lr=1e-4), True),
    "cosinerestart": (dict(periods=[2, 2], restart_weights=[1.0, 0.5], min_lr=1e-5), True),
    "cyclic": (dict(target_ratio=(10.0, 1e-3), cyclic_times=2, step_ratio_up=0.4), False),
    "onecycle": (dict(max_lr=5e-2, pct_start=0.25), True),
}
WARMUPS = [None, "constant", "linear", "exp"]


@pytest.mark.parametrize("warmup", WARMUPS, ids=lambda w: f"warmup_{w}")
@pytest.mark.parametrize("by_epoch", [True, False], ids=["by_epoch", "by_iter"])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_lr_schedule_matches_jax(policy, by_epoch, warmup):
    kw, transcendental = POLICIES[policy]
    if policy == "cosinerestart" and not by_epoch:
        kw = dict(kw, periods=[5, 6])
    common = dict(iters_per_epoch=IPE, by_epoch=by_epoch, warmup=warmup,
                  warmup_iters=4, warmup_ratio=0.2, **kw)
    port = optim.build_lr_schedule(policy, BASE_LR, TOTAL, **common)
    ref = jax_optim.build_lr_schedule(policy, BASE_LR, TOTAL, **common)
    want = np.asarray([np.float32(ref(jnp.int32(k))) for k in range(TOTAL + 2)])
    got = np.asarray([port(k) for k in range(TOTAL + 2)], np.float32)
    if transcendental or warmup == "exp":
        np.testing.assert_allclose(got, want, rtol=0, atol=4 * EPS32 * BASE_LR)
    else:
        np.testing.assert_array_equal(got, want)


def test_momentum_schedule_is_the_lr_vocabulary():
    port = optim.build_momentum_schedule("cyclic", 0.85, 10, by_epoch=False,
                                         target_ratio=(1.1, 0.9))
    ref = jax_optim.build_momentum_schedule("cyclic", 0.85, 10, by_epoch=False,
                                            target_ratio=(1.1, 0.9))
    assert [port(k) for k in range(10)] == [float(np.float32(ref(jnp.int32(k))))
                                            for k in range(10)]


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv(3, 4, (3, 3))
        self.GroupNorm_0 = GroupNorm(2, 4)
        self.Dense_0 = Dense(4, 2)


def _net(seed=0):
    rs = np.random.RandomState(seed)
    net = _Net()
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy(rs.randn(*p.shape).astype(np.float32)))
    return net


def _feed(net, grads):
    for n, p in net.named_parameters():
        p.grad = torch.from_numpy(grads[n].copy())


def _grad_stream(net, n, seed=1):
    """n gradient dicts (torch layout); global norms alternate above and
    below 1 so the clip acts on some steps and not on others."""
    rs = np.random.RandomState(seed)
    out = []
    for k in range(n):
        g = {name: rs.randn(*p.shape).astype(np.float32) for name, p in net.named_parameters()}
        scale = (3.0 if k % 2 == 0 else 0.3) / np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                                                          for v in g.values()))
        out.append({name: (v * scale).astype(np.float32) for name, v in g.items()})
    return out


def _flax_grads(net, grads):
    _feed(net, grads)
    tree = to_flax_grads(net)
    for p in net.parameters():
        p.grad = None
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(want, got, rtol=RTOL):
    for k, v in leaf_rel_errors(jax.tree_util.tree_map(np.asarray, want), got).items():
        assert v <= rtol, (k, v)


def _params(net):
    """A copy (``to_flax_params``' plain leaves share the parameters' memory)."""
    return jax.tree_util.tree_map(np.array, to_flax_params(net))


def _close_state(net, opt, opt_state):
    """optax's buffers against the port's, in flax layout."""
    if isinstance(opt, optim.ClippedAdam):
        got = to_flax_adam_state(net, opt.adam)
        got = {"mu": got["mu"], "nu": got["nu"]}
    else:
        names = [n for n, _ in net.named_parameters()]
        got = {k: _to_flax_tree(net, dict(zip(names, v))) for k, v in opt.buffers.items()}
    inner = opt_state.inner_opt_state if hasattr(opt_state, "inner_opt_state") else opt_state
    raw = jax.tree_util.tree_map(np.asarray, inner, is_leaf=lambda x: x is None)
    want = {}
    for d in _state_dicts(_as_raw(raw)):
        want.update({k: v["params"] for k, v in d.items() if k != "count"})
    assert set(want) == set(got), (set(want), set(got))
    for k in want:
        _close(want[k], got[k])


def _as_raw(node):
    """optax's NamedTuple states as the dicts a restored checkpoint holds."""
    if hasattr(node, "_asdict"):
        return {k: _as_raw(v) for k, v in node._asdict().items()} or None
    if isinstance(node, (list, tuple)):
        return [_as_raw(x) for x in node]
    return node


def _run_pair(cfg, n_steps, grad_clip=dict(max_norm=1.0), paramwise_cfg=None,
              cumulative_iters=1, schedule=("poly", dict(power=1.0))):
    """The port's optimizer and JAX's chain over the same fed gradients;
    the parameters' movement compared after every step."""
    net = _net()
    policy, kw = schedule
    jsched = jax_optim.build_lr_schedule(policy, cfg["lr"], 8, by_epoch=False,
                                         warmup="linear", warmup_iters=2, **kw)
    psched = optim.build_lr_schedule(policy, cfg["lr"], 8, by_epoch=False,
                                     warmup="linear", warmup_iters=2, **kw)
    tx = jax_optim.build_optimizer(dict(cfg), lr_schedule=jsched, grad_clip=grad_clip,
                                   accumulate_steps=cumulative_iters,
                                   paramwise_cfg=paramwise_cfg)
    opt = optim.build_optimizer(dict(cfg), net, grad_clip, lr_schedule=psched,
                                paramwise_cfg=paramwise_cfg,
                                cumulative_iters=cumulative_iters)
    params = {"params": jax.tree_util.tree_map(jnp.asarray, _params(net))}
    state = tx.init(params)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    for k, g in enumerate(_grad_stream(net, n_steps)):
        updates, state = update({"params": _flax_grads(net, g)}, state, params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad()
        _feed(net, g)
        opt.step()
        _close(params["params"], _params(net))
        _close_state(net, opt, state)
        if cumulative_iters > 1:
            names = [n for n, _ in net.named_parameters()]
            _close(state.acc_grads["params"], _to_flax_tree(net, dict(zip(names, opt.acc))))
    return opt, state


FACTORY = {
    "Adam": dict(type="Adam", lr=1e-2, betas=(0.8, 0.99), eps=1e-7),
    "Adam_wd": dict(type="Adam", lr=1e-2, weight_decay=1e-2),
    "AdamW": dict(type="AdamW", lr=1e-2),
    "SGD": dict(type="SGD", lr=0.1),
    "SGD_momentum_wd": dict(type="SGD", lr=0.1, momentum=0.9, weight_decay=1e-3),
    "SGD_nesterov": dict(type="SGD", lr=0.1, momentum=0.9, nesterov=True),
    "RMSprop": dict(type="RMSprop", lr=1e-2, alpha=0.9, weight_decay=1e-3),
    "RMSprop_momentum": dict(type="RMSprop", lr=1e-2, momentum=0.5),
    "Adagrad": dict(type="Adagrad", lr=0.1),
    "Adamax": dict(type="Adamax", lr=1e-2),
    "Lamb": dict(type="Lamb", lr=1e-2, weight_decay=1e-2),
    "Lion": dict(type="Lion", lr=1e-3, weight_decay=1e-2),
}


@pytest.mark.parametrize("name", list(FACTORY))
def test_factory_optimizer_matches_optax(name):
    opt, _ = _run_pair(FACTORY[name], 5)
    assert opt.count == 5


def _small_neuralrecon():
    import deep3dmap_tpu.models.frameworks.neuralrecon as jax_nr
    import deep3dmap_tpu_torch.models.frameworks.neuralrecon as torch_nr
    from torch_slice_helpers import train_fragments

    cfg = dict(N_LAYER=3, N_VOX=[16, 16, 16], VOXEL_SIZE=0.08,
               BACKBONE2D=dict(ARC="fpn-mnas-0.5"), FUSION=dict(FUSION_ON=True, FULL=True))
    frag = train_fragments(16, 1)[0]
    params, _ = jax_nr.NeuralRecon(cfg).init(jax.random.PRNGKey(0), frag)
    tfw = torch_nr.NeuralRecon(cfg, device="cpu")
    tfw.load_flax(jax.tree_util.tree_map(np.asarray, params))
    return params, tfw.net


PARAMWISE = dict(custom_keys={"backbone2d": dict(lr_mult=0.1, decay_mult=0.5),
                              "backbone2d.fpn.conv_0": dict(lr_mult=0.2)},
                 bias_lr_mult=2.0, bias_decay_mult=0.0, norm_decay_mult=0.0)


def test_paramwise_multipliers_leaf_by_leaf_on_neuralrecon():
    params, net = _small_neuralrecon()
    pre, post = jax_optim._paramwise_transforms(PARAMWISE, 1e-2)
    want_decay, want_lr = pre.init(params), post.init(params)
    decay, lr = optim.paramwise_mults(net, PARAMWISE)
    leaf = _leaf_map(net)
    seen = set()
    for (name, _), d, m in zip(net.named_parameters(), decay, lr):
        node_d, node_l = want_decay["params"], want_lr["params"]
        for k in leaf[name][0]:
            node_d, node_l = node_d[k], node_l[k]
        assert (d, m) == (float(node_d), float(node_l)), name
        seen.add((d, m))
    # every rule fires somewhere in the tree: both custom keys (the longer
    # one wins inside the shorter), bias (decay 0, lr x2), norm (decay 0)
    # and the rest
    assert seen == {(0.5, 0.1), (1.0, 0.2), (0.0, 2.0), (0.0, 1.0), (1.0, 1.0)}, seen
    assert len(decay) == len(jax.tree_util.tree_leaves(params))


def test_paramwise_adamw_curve_matches_optax():
    _run_pair(dict(type="AdamW", lr=1e-2, weight_decay=5e-2), 3, paramwise_cfg=dict(
        custom_keys={"conv_0": dict(lr_mult=0.5, decay_mult=2.0)}, bias_lr_mult=2.0,
        norm_decay_mult=0.0))


@pytest.mark.parametrize("k", [2, 3])
def test_multisteps_matches_optax(k):
    opt, state = _run_pair(dict(type="Adam", lr=1e-2), 7, cumulative_iters=k,
                           schedule=("cosineannealing", dict()))
    assert opt.count == int(state.gradient_step) == 7 // k
    assert opt.mini_step == int(state.mini_step) == 7 % k


def test_jax_checkpoint_with_adamw_paramwise_multisteps_resumes(tmp_path):
    from deep3dmap_tpu.runners.checkpoint import load_checkpoint_raw, save_checkpoint
    from deep3dmap_tpu.runners.train_state import TrainState as JaxTrainState

    cfg = dict(type="AdamW", lr=1e-2, weight_decay=1e-2)
    pw = dict(norm_decay_mult=0.0, bias_decay_mult=0.0)
    clip = dict(max_norm=1.0)
    net = _net()
    params = {"params": jax.tree_util.tree_map(jnp.asarray, _params(net))}
    jsched = jax_optim.build_lr_schedule("poly", 1e-2, 10, by_epoch=False,
                                         warmup="linear", warmup_iters=2)
    tx = jax_optim.build_optimizer(dict(cfg), lr_schedule=jsched, grad_clip=clip,
                                   accumulate_steps=2, paramwise_cfg=pw)
    grads = _grad_stream(net, 6)
    jstate = JaxTrainState.create(jax.random.PRNGKey(0), params, tx, {})
    opt_state = jstate.opt_state
    for g in grads[:3]:        # stops mid-window: mini_step 1
        updates, opt_state = tx.update({"params": _flax_grads(net, g)}, opt_state, params)
        params = optax.apply_updates(params, updates)
    jstate = jstate.replace(step=3, params=params, opt_state=opt_state)
    raw = load_checkpoint_raw(save_checkpoint(str(tmp_path), jstate))

    psched = optim.build_lr_schedule("poly", 1e-2, 10, by_epoch=False,
                                     warmup="linear", warmup_iters=2)
    fresh = _Net()
    state = TrainState(net=fresh, model_state={}, optimizer=optim.build_optimizer(
        dict(cfg), fresh, clip, lr_schedule=psched, paramwise_cfg=pw, cumulative_iters=2))
    state = load_jax_checkpoint(raw, state)
    opt = state.optimizer
    assert (state.step, opt.count, opt.mini_step) == (3, 1, 1)
    _close(params["params"], _params(fresh))
    for g in grads[3:]:
        updates, opt_state = tx.update({"params": _flax_grads(fresh, g)}, opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad()
        _feed(fresh, g)
        opt.step()
        _close(params["params"], _params(fresh))
        _close_state(fresh, opt, opt_state)
    # a chain of another structure does not load
    other = TrainState(net=_Net(), model_state={}, optimizer=optim.build_optimizer(
        dict(cfg), _Net(), clip, lr_schedule=psched, cumulative_iters=2))
    with pytest.raises(ValueError, match="JAX checkpoint"):
        load_jax_checkpoint(raw, other)


def test_port_checkpoint_round_trip_mid_window(tmp_path):
    """The accumulator, the counts and the buffers go into the port's
    checkpoint; a resumed optimizer steps on as the uninterrupted one."""
    from deep3dmap_tpu_torch.runners.checkpoint import load_checkpoint, save_checkpoint

    cfg, pw = dict(type="SGD", lr=0.1, momentum=0.9), dict(bias_lr_mult=2.0)

    def make():
        net = _net()
        return TrainState(net=net, model_state={}, optimizer=optim.build_optimizer(
            dict(cfg), net, dict(max_norm=1.0), paramwise_cfg=pw, cumulative_iters=2))

    a, b = make(), make()
    grads = _grad_stream(a.net, 5)
    for g in grads[:3]:
        for s in (a, b):
            s.optimizer.zero_grad()
            _feed(s.net, g)
            s.optimizer.step()
    a.step = 3
    path = save_checkpoint(str(tmp_path), a)
    c = load_checkpoint(path, make(), map_location="cpu")
    assert (c.optimizer.count, c.optimizer.mini_step) == (1, 1)
    for g in grads[3:]:
        for s in (b, c):
            s.optimizer.zero_grad()
            _feed(s.net, g)
            s.optimizer.step()
    for p, q in zip(b.net.parameters(), c.net.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
