"""The port's bundle adjustment (``deep3dmap_tpu_torch/core/sfm/ba.py``)
against the JAX package's ``core/sfm/ba.py`` on the CPU, in float64 (x64
on for this module, restored after it), on ``tests/test_sfm.py``'s ring
scene (6 cameras, 64 points) with 0.5 px of noise and a perturbed start.

* projection, residuals, the robust cost: 1e-12 relative;
* ``_obs_jacobians``, ``_normal_blocks`` (B, Cp, U, gc, gp, cost) and one
  ``_schur_solve`` step, with and without Huber: 1e-10 relative;
* ``lm_solve``, 20 iterations, with and without Huber (with gross
  outliers): R, t, X and the cost 1e-8 relative; the accept sequence and
  ``lam`` equal while the decisions are above rounding.  Past the cost's
  floor (the 6th iteration here) ``new_cost < cost`` compares two costs
  equal to ~1e-15 relative, and either side may take a step of the size of
  rounding (``sfm_helpers.accept_prefix``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep3dmap_tpu.core import sfm as jsfm
from deep3dmap_tpu.core.sfm import ba as jba
from deep3dmap_tpu_torch.core import sfm
from deep3dmap_tpu_torch.core.sfm import ba
from deep3dmap_tpu_torch.utils.from_flax import from_jax_tuple
from sfm_helpers import accept_prefix, np_, perturb, rel_err, ring_scene

T = torch.tensor
HUBER = {"l2": None, "huber": 2.0}


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module", params=sorted(HUBER))
def case(request):
    """(huber, start (R0, t0, X0), JAX problem, port problem)."""
    rng = np.random.RandomState(11)
    K, Rs, ts, X, prob = ring_scene(rng, n_cams=6, n_pts=64, noise=0.5)
    huber = HUBER[request.param]
    if huber is not None:     # gross outliers: the IRLS weights bite
        uv = prob.uv.copy()
        uv[::37] += 80.0
        prob = prob._replace(uv=uv)
    start = perturb(rng, Rs, ts, X)
    jprob = jba.BAProblem(*map(jnp.asarray, prob))
    tprob = from_jax_tuple(ba.BAProblem, prob, device="cpu")
    assert tprob.cam_idx.dtype == torch.int64 and tprob.cam_fixed.dtype == torch.bool
    return huber, start, jprob, tprob


def test_project_residuals_cost(case):
    huber, (R0, t0, X0), jprob, tprob = case
    rj = jax.jit(jsfm.reprojection_residuals)(R0, t0, X0, jprob)
    rt = sfm.reprojection_residuals(T(R0), T(t0), T(X0), tprob)
    assert rel_err(rj, np_(rt)) < 1e-12
    cj = jax.jit(lambda r: jba.robust_cost(r, huber))(rj)
    assert rel_err(cj, np_(ba.robust_cost(rt, huber))) < 1e-12
    uvj, zj = jax.jit(jsfm.project)(jprob.K[0], R0[1], t0[1], X0)
    uvt, zt = sfm.project(tprob.K[0], T(R0[1]), T(t0[1]), T(X0))
    assert rel_err(uvj, np_(uvt)) < 1e-12 and rel_err(zj, np_(zt)) < 1e-12


def test_obs_jacobians(case):
    _, (R0, t0, X0), jprob, tprob = case
    ci, pi = np.asarray(jprob.cam_idx), np.asarray(jprob.pt_idx)
    args = (R0[ci], t0[ci], np.asarray(jprob.K)[ci], X0[pi])
    for a, b in zip(jax.jit(jba._obs_jacobians)(*args), ba._obs_jacobians(*map(T, args))):
        assert rel_err(a, np_(b)) < 1e-10


@pytest.fixture(scope="module")
def blocks(case):
    huber, (R0, t0, X0), jprob, tprob = case
    bj = jax.jit(lambda R, t, X: jba._normal_blocks(R, t, X, jprob, huber))(R0, t0, X0)
    bt = ba._normal_blocks(T(R0), T(t0), T(X0), tprob, huber)
    return bj, bt


@pytest.mark.parametrize("name", ["B", "Cp", "U", "gc", "gp", "cost"])
def test_normal_blocks(blocks, name):
    k = ["B", "Cp", "U", "gc", "gp", "cost"].index(name)
    bj, bt = blocks
    assert rel_err(bj[k], np_(bt[k])) < 1e-10


def test_schur_step(case, blocks):
    """One damped step from the same blocks (JAX's), at two dampings."""
    _, _, jprob, tprob = case
    bj, _ = blocks
    bj = [np.asarray(b) for b in bj[:5]]
    for lam in (1e-3, 10.0):
        dj = jax.jit(jba._schur_solve)(*bj, jnp.asarray(lam), jprob.cam_fixed)
        dt = ba._schur_solve(*map(T, bj), torch.tensor(lam, dtype=torch.float64),
                             tprob.cam_fixed)
        for a, b in zip(dj, dt):
            assert rel_err(a, np_(b)) < 1e-10
        assert np.all(np_(dt[0])[:2] == 0.0)           # the fixed cameras


def test_lm_solve(case, monkeypatch):
    huber, (R0, t0, X0), jprob, tprob = case
    iters = 20
    run_j = jax.jit(lambda R, t, X, n: jsfm.lm_solve(R, t, X, jprob, iters=n, huber=huber))
    jres = [run_j(R0, t0, X0, n) for n in range(iters + 1)]
    jc = [float(r.cost) for r in jres]
    jl = [float(r.lam) for r in jres]

    # the port one iteration a call, continued from each result's lam; the
    # cost function's calls give each iteration's candidate
    seen = []
    orig = ba.robust_cost

    def spy(r, h):
        c = orig(r, h)
        seen.append(float(c))
        return c
    monkeypatch.setattr(ba, "robust_cost", spy)
    state, lam = (T(R0), T(t0), T(X0)), 1e-3
    costs, lams, cands = [], [], []
    for _ in range(iters):
        seen.clear()
        res = sfm.lm_solve(*state, tprob, iters=1, lam0=lam, huber=huber)
        costs.append(seen[0])
        cands.append(seen[1])
        state, lam = (res.R, res.t, res.X), res.lam
        lams.append(float(lam))
    monkeypatch.undo()
    whole = sfm.lm_solve(T(R0), T(t0), T(X0), tprob, iters=iters, huber=huber)
    for a, b in zip((whole.R, whole.t, whole.X, whole.cost, whole.lam), (*state, res.cost, lam)):
        assert torch.equal(a, b)
    assert int(whole.iterations) == iters and float(whole.initial_cost) == costs[0]

    costs.append(float(res.cost))
    n = accept_prefix(costs, cands)
    assert n >= 3, n
    assert rel_err(jl[1:n + 1], lams[:n]) < 1e-12
    assert rel_err(jc[:n + 1], costs[:n + 1]) < 1e-10
    assert float(whole.cost) < float(whole.initial_cost)
    final = jres[-1]
    for a, b in zip((final.R, final.t, final.X, final.cost, final.initial_cost),
                    (whole.R, whole.t, whole.X, whole.cost, whole.initial_cost)):
        assert rel_err(a, np_(b)) < 1e-8
