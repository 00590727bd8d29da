"""The port's optimizer (``runners/optim.py``) against optax, given the same
gradients: ``build_optimizer(dict(type="Adam", ...), grad_clip=dict(max_norm))``
is ``optax.chain(clip_by_global_norm(max_norm), adam(...))``.

Three steps, with gradients whose global norm is above the clip (clipped)
and below it (passed through).  Parameters, the clipped gradients and Adam's
moments are compared leaf by leaf in flax layout (``to_flax_params``,
``to_flax_adam_state``).  Tolerances: the same float32 formulas in another
order (torch lerps the first moment and divides by the bias corrections at
other points), so moments and updates agree to float32 rounding: RTOL
relative, and parameters (~1) to ATOL after updates of ~1e-3.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deep3dmap_tpu_torch.models.layers import Conv, Dense, GroupNorm
from deep3dmap_tpu_torch.runners.optim import (build_optimizer,
                                               clip_by_global_norm_, global_norm)
from deep3dmap_tpu_torch.utils.from_flax import (to_flax_adam_state,
                                                 to_flax_grads, to_flax_params)
from torch_slice_helpers import leaf_rel_errors

RTOL = 1e-6
ATOL = 1e-7
LR, BETAS, EPS = 1e-3, (0.9, 0.999), 1e-8


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv(3, 4, (3, 3))
        self.GroupNorm_0 = GroupNorm(2, 4)
        self.Dense_0 = Dense(4, 2)


def _net(rng):
    net = _Net()
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))
    return net


def _grads(rng, net, norm):
    """Per-parameter gradients (torch layout) with the given global norm."""
    gs = {n: rng.randn(*p.shape).astype(np.float32) for n, p in net.named_parameters()}
    scale = norm / np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in gs.values()))
    return {n: (g * scale).astype(np.float32) for n, g in gs.items()}


def _to_flax(net, grads):
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.grad = torch.from_numpy(grads[n])
    tree = to_flax_grads(net)
    for p in net.parameters():
        p.grad = None
    return tree


def _close(want, got, **tol):
    for k, v in leaf_rel_errors(want, got).items():
        assert v <= tol.get("rtol", RTOL), (k, v)


@pytest.mark.parametrize("norms", [(3.0, 5.0, 2.0), (0.5, 0.2, 0.9), (3.0, 0.5, 1.0)],
                         ids=["clipped", "unclipped", "mixed"])
def test_clip_and_adam_match_optax(rng, norms):
    net = _net(rng)
    opt = build_optimizer(dict(type="Adam", lr=LR, betas=BETAS, eps=EPS),
                          net.parameters(), dict(max_norm=1.0))
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adam(LR, b1=BETAS[0], b2=BETAS[1], eps=EPS))
    params = jax.tree_util.tree_map(jnp.asarray, to_flax_params(net))
    state = tx.init(params)
    for norm in norms:
        g = _grads(rng, net, norm)
        g_flax = jax.tree_util.tree_map(jnp.asarray, _to_flax(net, g))
        # optax's clipped gradients, for the clip alone
        clipped, _ = optax.clip_by_global_norm(1.0).update(g_flax, optax.EmptyState())
        updates, state = tx.update(g_flax, state, params)
        params = optax.apply_updates(params, updates)

        opt.zero_grad()
        for n, p in net.named_parameters():
            p.grad = torch.from_numpy(g[n].copy())
        got_norm = opt.step()
        np.testing.assert_allclose(float(got_norm), norm, rtol=RTOL)
        _close(jax.tree_util.tree_map(np.asarray, clipped), to_flax_grads(net))
        for k, v in leaf_rel_errors(jax.tree_util.tree_map(np.asarray, params),
                                    to_flax_params(net)).items():
            assert v <= ATOL, (k, v)
        adam_state = state[1][0]
        got = to_flax_adam_state(net, opt.adam)
        assert got["count"] == int(adam_state.count)
        _close(jax.tree_util.tree_map(np.asarray, adam_state.mu), got["mu"])
        _close(jax.tree_util.tree_map(np.asarray, adam_state.nu), got["nu"])


def test_clip_is_optax_rule_not_clip_grad_norm(rng):
    """Below the bound the gradients pass bit for bit (``clip_grad_norm_``
    would scale them by max_norm / (norm + 1e-6)); above it they are
    ``(g / norm) * max_norm``, as optax writes it."""
    net = _net(rng)
    for norm in (0.999, 4.0):
        g = _grads(rng, net, norm)
        ts = [torch.from_numpy(v.copy()) for v in g.values()]
        n = global_norm(ts)
        want = optax.global_norm([jnp.asarray(v) for v in g.values()])
        np.testing.assert_allclose(float(n), float(want), rtol=RTOL)
        clip_by_global_norm_(ts, n, 1.0)
        for t, v in zip(ts, g.values()):
            if norm < 1.0:
                np.testing.assert_array_equal(t.numpy(), v)
            else:
                np.testing.assert_array_equal(t.numpy(), (v / np.float32(n)) * 1.0)


@pytest.mark.parametrize("cfg,clip", [
    (dict(type="SGD", lr=0.1), None),
    (dict(type="AdamW", lr=1e-3), None),
    (dict(type="Adam", lr=1e-3, weight_decay=1e-2), None),
    (dict(type="Adam", lr=1e-3, amsgrad=True), None),
    (dict(type="Adam", lr=1e-3), dict(max_norm=1.0, norm_type=2)),
])
def test_other_optimizers_and_options_raise(rng, cfg, clip):
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        build_optimizer(cfg, _net(rng).parameters(), clip)


def test_step_without_gradients_raises(rng):
    opt = build_optimizer(dict(type="Adam", lr=1e-3), _net(rng).parameters())
    with pytest.raises(RuntimeError, match="no parameter has a gradient"):
        opt.step()
