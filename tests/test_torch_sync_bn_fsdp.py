"""``SyncBatchNorm`` and FSDP / ZeRO on the CPU: the port's 2 ranks are gloo
processes (``torch_dist.run_ranks``, started once for the file); JAX's side
runs on the conftest's 8-device CPU mesh.

- ``SyncBatchNorm`` in training mode, each rank on half of a (4, 5, 3)
  batch, against JAX's ``SyncBatchNorm`` (flax BatchNorm) under
  ``shard_map`` over a 2-device ``data`` axis: outputs, the updated
  running statistics and the gradients of a cotangent to 1e-5 (measured
  2.4e-7 for the outputs, 1.2e-7 for the statistics, 4.8e-7 for the
  parameters' summed gradients); without a group it is plain BatchNorm
  (the whole batch on one rank equals JAX's unsharded call).
- The FSDP and ZeRO specs against JAX's ``fsdp_specs``, ``zero_specs`` and
  ``separate_group_specs`` on ``tests/test_fsdp_amp.py``'s toy params.
- ``tests/test_fsdp_amp.py:44-60``'s step with the toy net sharded by
  ``fsdp_shard`` (FSDP2; the small bias left whole, its gradient averaged
  by the hook) against the same net unsharded: loss and gradients to
  1e-5, the Adam step's parameters to 1e-6 (measured: all equal); each
  parameter's placement; ``zero_shard``'s Adam state held for half of each
  sharded parameter, its step equal to plain Adam's (measured: equal).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

from deep3dmap_tpu.models.modulars.norm import SyncBatchNorm as JaxSyncBN
from deep3dmap_tpu.parallel import fsdp_specs as jax_fsdp_specs
from deep3dmap_tpu.parallel import make_mesh as jax_make_mesh
from deep3dmap_tpu.parallel import separate_group_specs as jax_separate
from deep3dmap_tpu.parallel import zero_specs as jax_zero_specs
from deep3dmap_tpu_torch.models.modulars import SyncBatchNorm
from deep3dmap_tpu_torch.parallel import fsdp_specs, separate_group_specs, zero_specs
from deep3dmap_tpu_torch.parallel.mesh import Mesh
from deep3dmap_tpu_torch.utils.from_flax import load_flax_params
from torch_dist import ToyNet, run_ranks, save_inputs

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

TOL_BN = 1e-5
TOL_FSDP = 1e-5
TOL_STEP = 1e-6


def _toy():
    rng = np.random.RandomState(0)
    return {"dense": {"kernel": rng.randn(256, 128).astype(np.float32),
                      "bias": np.zeros(128, np.float32)},
            "head": {"kernel": rng.randn(128, 8).astype(np.float32)}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bn")
    rs = np.random.RandomState(3)
    x = (rs.randn(4, 5, 3) * 2 + 1).astype(np.float32)
    ct = rs.randn(4, 5, 3).astype(np.float32)
    bn = JaxSyncBN(use_running_average=False)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rs.randn(*np.shape(v)).astype(np.float32) * 0.1,
        variables["params"])
    toy = _toy()
    flat = {"dense_kernel": toy["dense"]["kernel"], "dense_bias": toy["dense"]["bias"],
            "head_kernel": toy["head"]["kernel"]}
    xy = (np.random.RandomState(1).randn(16, 256).astype(np.float32),
          np.random.RandomState(2).randn(16, 8).astype(np.float32))
    path = save_inputs(tmp, "bn_in.pt", dict(bn_x=x, bn_ct=ct, bn_params=params,
                                             toy=flat, x=xy[0], y=xy[1]))
    ranks = run_ranks(2, "sync_bn_fsdp", tmp, inputs=path)
    return dict(x=x, ct=ct, params=params, variables=variables, flat=flat, xy=xy), ranks


def test_sync_batch_norm_against_flax_pmean(runs):
    d, ranks = runs
    mesh = jax_make_mesh(("data",), (2,))
    bn = JaxSyncBN(use_running_average=False)
    stats0 = d["variables"]["batch_stats"]

    def local(x, ct):
        def f(x, p):
            y, upd = bn.apply({"params": p, "batch_stats": stats0}, x,
                              mutable=["batch_stats"])
            return jnp.sum(y * ct), (y, upd["batch_stats"])
        (_, (y, stats)), (dx, dp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            x, d["params"])
        # d["params"] enters replicated: its gradient is already the sum over
        # the devices (the transpose of the implicit broadcast)
        return y, dx, stats, dp

    y, dx, stats, dp = shard_map(local, mesh=mesh, in_specs=(P("data"), P("data")),
                                 out_specs=(P("data"), P("data"), P(), P()))(
        jnp.asarray(d["x"]), jnp.asarray(d["ct"]))
    got_y = np.concatenate([r["bn"]["y"] for r in ranks])
    got_dx = np.concatenate([r["bn"]["dx"] for r in ranks])
    np.testing.assert_allclose(got_y, np.asarray(y), atol=TOL_BN, rtol=TOL_BN)
    np.testing.assert_allclose(got_dx, np.asarray(dx), atol=TOL_BN, rtol=TOL_BN)
    for r in ranks:
        b = r["bn"]
        np.testing.assert_allclose(b["mean"], np.asarray(stats["bn"]["mean"]), atol=TOL_BN)
        np.testing.assert_allclose(b["var"], np.asarray(stats["bn"]["var"]), atol=TOL_BN)
        np.testing.assert_allclose(b["dscale"], np.asarray(dp["bn"]["scale"]), atol=TOL_BN,
                                   rtol=TOL_BN)
        np.testing.assert_allclose(b["dbias"], np.asarray(dp["bn"]["bias"]), atol=TOL_BN,
                                   rtol=TOL_BN)


def test_batch_norm_without_group_is_plain(runs):
    d, _ = runs
    bn = JaxSyncBN(use_running_average=False)
    y, upd = bn.apply({"params": d["params"], "batch_stats": d["variables"]["batch_stats"]},
                      jnp.asarray(d["x"]), mutable=["batch_stats"])
    port = SyncBatchNorm(3, use_running_average=False)
    load_flax_params(port, d["params"])
    got = port(torch.tensor(d["x"]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), atol=TOL_BN, rtol=TOL_BN)
    np.testing.assert_allclose(port.bn.mean.numpy(), upd["batch_stats"]["bn"]["mean"],
                               atol=TOL_BN)
    np.testing.assert_allclose(port.bn.var.numpy(), upd["batch_stats"]["bn"]["var"],
                               atol=TOL_BN)
    eval_y = port(torch.tensor(d["x"]), use_running_average=True)
    want = JaxSyncBN().apply({"params": d["params"], "batch_stats": upd["batch_stats"]},
                             jnp.asarray(d["x"]), use_running_average=True)
    np.testing.assert_allclose(eval_y.detach().numpy(), np.asarray(want), atol=TOL_BN,
                               rtol=TOL_BN)


def _as_tuple(spec):
    return tuple(spec)


@pytest.mark.parametrize("n", [2, 8])
def test_specs_against_jax(n):
    toy = _toy()
    jmesh = jax_make_mesh(("data",), (n,))
    mesh = Mesh(("data",), (n,))
    for min_size in (1024, 2 ** 14):
        want = jax.tree_util.tree_map(_as_tuple, jax_fsdp_specs(toy, jmesh, min_size=min_size),
                                      is_leaf=lambda s: isinstance(s, P))
        assert fsdp_specs(toy, mesh, min_size=min_size) == want
    opt_state = optax.adam(1e-3).init(jax.tree_util.tree_map(jnp.asarray, toy))
    zs = jax_zero_specs(opt_state, toy, jmesh, min_size=1024)
    want = [tuple(s) for s in jax.tree_util.tree_leaves(zs, is_leaf=lambda s: isinstance(s, P))]
    state = {"count": np.zeros((), np.int32), "mu": toy, "nu": toy}
    got = zero_specs(state, toy, mesh, min_size=1024)
    flat = [got["count"]] + [got[k][m][p] for k in ("mu", "nu")
                             for m, p in (("dense", "bias"), ("dense", "kernel"),
                                          ("head", "kernel"))]
    assert sorted(flat, key=str) == sorted(want, key=str)
    groups = {"generator": toy, "discriminator": toy}
    want = jax.tree_util.tree_map(_as_tuple, jax_separate(groups, jmesh, {"generator": "data"}),
                                  is_leaf=lambda s: isinstance(s, P))
    assert separate_group_specs(groups, mesh, {"generator": "data"}) == want


def _replicated_step(d):
    net = ToyNet()
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(torch.tensor(d["flat"][name]))
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    loss = net(*map(torch.tensor, d["xy"]))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    opt.step()
    return float(loss), grads, {n: p.detach().clone() for n, p in net.named_parameters()}


def test_fsdp_step_against_replicated(runs):
    d, ranks = runs
    loss, grads, params = _replicated_step(d)
    for r in ranks:
        assert r["placements"] == {"dense_kernel": "(Shard(dim=0),)",
                                   "dense_bias": "whole",
                                   "head_kernel": "(Shard(dim=0),)"}, r["placements"]
        np.testing.assert_allclose(r["fsdp_loss"], loss, rtol=TOL_FSDP)
        for n, g in grads.items():
            np.testing.assert_allclose(r["fsdp_grads"][n], g.numpy(), rtol=TOL_FSDP,
                                       atol=TOL_FSDP, err_msg=n)
        for n, p in params.items():
            np.testing.assert_allclose(r["fsdp_params"][n], p.numpy(), atol=TOL_STEP,
                                       err_msg=n)


def test_zero_step_against_plain_adam(runs):
    d, ranks = runs
    _, _, params = _replicated_step(d)
    for r in ranks:
        for n, p in params.items():
            np.testing.assert_allclose(r["zero_params"][n], p.numpy(), atol=TOL_STEP,
                                       err_msg=n)
        # Adam's moments for half of each sharded parameter, whole for the bias
        assert r["zero_state"] == {(128, 128): (128, 128), (64, 8): (64, 8),
                                   (128,): (128,)}, r["zero_state"]
