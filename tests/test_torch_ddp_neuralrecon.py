"""Data-parallel NeuralRecon training on the CPU: the port's 2 ranks are gloo
processes (``torch_dist.run_ranks``, started once for the file), each with
one fragment of a global batch of 2 (dense 16³, 2 views at 64²).

- Against the port's one-rank step on the same global batch: the loss and
  its levels to 1e-5 relative (measured 1.3e-7: the fused loss's sums are
  all-reduced before the combine, so only their order differs), the
  3-step clip + Adam curve to 1e-3 (measured 1.0e-5), and the summed
  gradient: the whole to 1e-4 relative, each leaf to 2e-3 of its own norm
  (measured 1.9e-5 and 3.8e-4).  Leaves do not agree to 1e-5 of their own
  norm: the CPU's 3D convs round a batch of one differently from a batch
  of two (2.2e-6 in the finest tsdf), the backward carries that through
  ReLU and GroupNorm, and the backbone's GroupNorm biases sum cotangents
  that cancel (their norms are ~0.3% of the whole's).
- Against JAX's sharded step (the same weights; the batch sharded over a
  2-device ``data`` axis of the conftest's CPU mesh): the loss and its
  levels, and every gradient leaf, within the whole-slice bounds of
  ``tests/test_torch_neuralrecon_train.py`` (measured: the loss 2.2e-6,
  leaves 1.9e-2 off ``backbone2d`` and 8.2e-2 in it, the whole 6.5e-3).
- The block-sparse config (32³, float32, one step) at 2 ranks against the
  port's one rank: the loss bit-equal, its levels to 1e-5 (measured
  1.6e-7), the whole gradient to 3e-4 (measured 6.8e-5) and each leaf to
  2e-3 of its norm (measured 3.3e-4).  A backward fed each rank's own
  mask sums in place of the all-reduced ones leaves the loss as it is but
  lands the whole gradient 1.06 off and its worst leaf 1.31: these bounds
  are what catch it.
- The fused loss's ``group=`` path at world size 1 (a one-rank group on
  each rank) against no group: bit-equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import deep3dmap_tpu.models.frameworks.neuralrecon as jax_nr
from deep3dmap_tpu.parallel import make_mesh as jax_make_mesh
from deep3dmap_tpu_torch.models.frameworks.neuralrecon import NeuralRecon
from deep3dmap_tpu_torch.runners.optim import build_optimizer
from deep3dmap_tpu_torch.runners.train_state import TrainState, train_step
from deep3dmap_tpu_torch.utils.from_flax import to_flax_grads, to_flax_params
from test_torch_neuralrecon_train import (BACKBONE_GRAD_RTOL, CFGS, GLOBAL_GRAD_RTOL,
                                          GRAD_RTOL, LOSS_RTOL)
from torch_dist import run_ranks, save_inputs
from torch_slice_helpers import _jax_state, leaf_rel_errors, two_fragments

torch.set_num_threads(2)

DP_LOSS_RTOL = 1e-5
DP_CURVE_RTOL = 1e-3
DP_WHOLE_GRAD_RTOL = 1e-4
DP_LEAF_GRAD_RTOL = 2e-3
DP_BLOCK_WHOLE_GRAD_RTOL = 3e-4
N_STEPS = 3
CFG = CFGS["dense"][0]
BLOCK_CFG = CFGS["block"][0]


def _flat(tree):
    return np.concatenate([np.ravel(v) if not isinstance(v, dict) else _flat(v)
                           for _, v in sorted(tree.items())])


def _one_rank(fw, frags):
    """The port's step on the whole global batch, no group."""
    net = fw.net
    state = TrainState(net=net, model_state=fw.init_state(2),
                       optimizer=build_optimizer(dict(type="Adam", lr=1e-3), net.parameters(),
                                                 dict(max_norm=1.0)))
    loss, aux = fw.loss_fn(net, state.model_state, frags[0])
    loss.backward()
    out = dict(loss=float(loss), logs={k: float(v) for k, v in aux["log_vars"].items()},
               grads=to_flax_grads(net))
    state.optimizer.zero_grad()
    curve = []
    for b in frags[:N_STEPS]:
        state, logs = train_step(fw, state, b)
        curve.append(float(logs["loss"]))
    out["curve"] = curve
    return out


def _jax_sharded(flax_params, batch):
    """JAX's ``value_and_grad(loss_fn)`` with the batch and the state sharded
    over a 2-device ``data`` axis, as ``tools/benchmark_scaling.py`` runs it."""
    fw = jax_nr.NeuralRecon(CFG)
    mesh = jax_make_mesh(("data",), (2,))
    dp, repl = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())

    def put(x):
        x = jnp.asarray(x)
        return jax.device_put(x, dp if x.ndim and x.shape[0] == 2 else repl)

    params = jax.tree_util.tree_map(lambda x: jax.device_put(jnp.asarray(x), repl),
                                    {"params": flax_params})
    mstate = jax.tree_util.tree_map(put, _jax_state(fw, batch))
    with mesh:
        (loss, aux), grads = jax.jit(jax.value_and_grad(fw.loss_fn, has_aux=True))(
            params, mstate, jax.tree_util.tree_map(put, batch), jax.random.PRNGKey(0))
    return dict(loss=float(loss), logs={k: float(v) for k, v in aux["log_vars"].items()},
                grads=jax.tree_util.tree_map(np.asarray, grads)["params"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    frags = two_fragments(2, 16, seeds=((0, 1), (2, 3), (4, 5)))
    path = save_inputs(tmp, "ddp_in.pt", dict(cfg=CFG, batches=frags))
    ranks = run_ranks(2, "ddp_neuralrecon", tmp, inputs=path, n_steps=N_STEPS)
    fw = NeuralRecon(CFG, device="cpu")
    fw.init(0, frags[0])
    # a copy: to_flax_params' leaves share memory with the weights it steps
    flax_params = jax.tree_util.tree_map(np.array, to_flax_params(fw.net))
    return ranks, _one_rank(fw, frags), _jax_sharded(flax_params, frags[0])


@pytest.fixture(scope="module")
def block_runs(tmp_path_factory):
    """The block-sparse config (32³, float32) at 2 ranks, one step, and the
    port's one rank on the same global batch."""
    tmp = tmp_path_factory.mktemp("ddp_block")
    frags = two_fragments(2, 32, seeds=((0, 1),))
    path = save_inputs(tmp, "ddp_block_in.pt", dict(cfg=BLOCK_CFG, batches=frags))
    ranks = run_ranks(2, "ddp_neuralrecon", tmp, inputs=path, n_steps=1)
    fw = NeuralRecon(BLOCK_CFG, device="cpu")
    fw.init(0, frags[0])
    return ranks, _one_rank(fw, frags)


def test_ranks_agree_with_each_other(runs):
    ranks, _, _ = runs
    a, b = ranks
    assert a["loss"] == b["loss"] and a["curve"] == b["curve"]
    assert np.array_equal(_flat(a["grads"]), _flat(b["grads"]))
    # one all-reduce of the loss's sums and one gradient bucket a step
    assert a["counts"] == {"all_reduce": 2}, a["counts"]


def test_step_against_one_rank(runs):
    ranks, one, _ = runs
    got = ranks[0]
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=DP_LOSS_RTOL)
    for k, v in one["logs"].items():
        np.testing.assert_allclose(got["logs"][k], v, rtol=DP_LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(got["curve"], one["curve"], rtol=DP_CURVE_RTOL)
    g, w = _flat(got["grads"]), _flat(one["grads"])
    assert np.linalg.norm(g - w) <= DP_WHOLE_GRAD_RTOL * np.linalg.norm(w)
    rel = leaf_rel_errors(one["grads"], got["grads"])
    bad = {k: v for k, v in rel.items() if v > DP_LEAF_GRAD_RTOL}
    assert not bad, bad


def test_step_against_jax_sharded(runs):
    ranks, _, jx = runs
    got = ranks[0]
    np.testing.assert_allclose(got["loss"], jx["loss"], rtol=LOSS_RTOL)
    for k, v in jx["logs"].items():
        np.testing.assert_allclose(got["logs"][k], v, rtol=LOSS_RTOL, err_msg=k)
    rel = leaf_rel_errors(jx["grads"], got["grads"])
    assert len(rel) == 232
    whole = leaf_rel_errors({"g": _flat(jx["grads"])}, {"g": _flat(got["grads"])})
    assert whole["g"] <= GLOBAL_GRAD_RTOL, whole
    bad = {k: v for k, v in rel.items()
           if v > (BACKBONE_GRAD_RTOL if k.startswith("backbone2d/") else GRAD_RTOL)}
    assert not bad, bad


def test_loss_group_of_one_rank_is_bit_equal(runs):
    ranks, _, _ = runs
    for ref, one, equal in (r["one_rank"] for r in ranks):
        assert equal and ref == one


def test_block_step_against_one_rank(block_runs):
    """The block levels pick their active blocks per fragment from the
    occupancy logits, so a rank holding one fragment must pick what one
    rank holding both picks; the loss, its levels and the summed gradient
    then agree as the dense step's do."""
    ranks, one = block_runs
    a, b = ranks
    assert a["loss"] == b["loss"] and np.array_equal(_flat(a["grads"]), _flat(b["grads"]))
    np.testing.assert_allclose(a["loss"], one["loss"], rtol=DP_LOSS_RTOL)
    for k, v in one["logs"].items():
        np.testing.assert_allclose(a["logs"][k], v, rtol=DP_LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(a["curve"], one["curve"], rtol=DP_CURVE_RTOL)
    g, w = _flat(a["grads"]), _flat(one["grads"])
    assert np.linalg.norm(g - w) <= DP_BLOCK_WHOLE_GRAD_RTOL * np.linalg.norm(w)
    rel = leaf_rel_errors(one["grads"], a["grads"])
    bad = {k: v for k, v in rel.items() if v > DP_LEAF_GRAD_RTOL}
    assert not bad, bad
