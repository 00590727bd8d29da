"""``lm_solve_sharded`` on the CPU in float64: the port's 4 ranks are gloo
processes (``torch_dist.run_ranks``, started once for the file), each with
a quarter of the observations of ``sfm_helpers.ring_scene`` (6 cameras, 63
points: M = 378 pads to 380 with w = 0 slots).

Each rank solves from the same start for 1..20 iterations.  Against the
port's ``lm_solve`` on the whole problem the costs and the damping agree
to 1e-10 while the accept decisions hold (``sfm_helpers.accept_prefix``;
measured: the costs 3.9e-15 through all 20 iterations, the damping parts
past the prefix, where a decision reads two costs equal to rounding);
the ranks' results are identical, and each iteration issues two
all-reduces (the blocks, the candidate's cost) after one for the start's
cost.  Against JAX's ``lm_solve_sharded`` over a 4-device mesh of the
conftest's CPU devices, the 20-iteration result to 1e-8, as
``tests/test_torch_sfm_ba.py`` holds ``lm_solve`` (measured 2.0e-10).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep3dmap_tpu.core import sfm as jsfm
from deep3dmap_tpu.core.sfm import ba as jba
from deep3dmap_tpu.parallel import make_mesh as jax_make_mesh
from deep3dmap_tpu_torch.core import sfm
from deep3dmap_tpu_torch.core.sfm import ba
from deep3dmap_tpu_torch.utils.from_flax import from_jax_tuple
from sfm_helpers import accept_prefix, np_, perturb, rel_err, ring_scene
from torch_dist import run_ranks, save_inputs

T = torch.tensor
ITERS = 20
N_RANKS = 4


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, x64):
    rng = np.random.RandomState(11)
    K, Rs, ts, X, prob = ring_scene(rng, n_cams=6, n_pts=63, noise=0.5)
    start = perturb(rng, Rs, ts, X)
    tprob = from_jax_tuple(ba.BAProblem, prob, device="cpu")
    tmp = tmp_path_factory.mktemp("ba")
    path = save_inputs(tmp, "ba_in.pt", dict(start=tuple(T(a) for a in start), prob=tprob,
                                             huber=None))
    ranks = run_ranks(N_RANKS, "ba", tmp, inputs=path, iters=ITERS)
    return start, prob, tprob, ranks


def test_ranks_identical(runs):
    *_, ranks = runs
    for r in ranks[1:]:
        for a, b in zip(ranks[0], r):
            for k in ("R", "t", "X", "cost", "lam"):
                assert np.array_equal(a[k], b[k]), k
    # the start's cost, then the blocks and the candidate's cost an iteration
    for n, res in enumerate(ranks[0], start=1):
        assert res["counts"] == {"all_reduce": 1 + 2 * n}, (n, res["counts"])


def test_against_lm_solve(runs, monkeypatch):
    start, _, tprob, ranks = runs
    seen = []
    orig = ba.robust_cost

    def spy(r, h):
        c = orig(r, h)
        seen.append(float(c))
        return c
    monkeypatch.setattr(ba, "robust_cost", spy)
    state, lam = tuple(T(a) for a in start), 1e-3
    costs, cands, lams = [], [], []
    for _ in range(ITERS):
        seen.clear()
        res = sfm.lm_solve(*state, tprob, iters=1, lam0=lam)
        costs.append(seen[0])
        cands.append(seen[1])
        state, lam = (res.R, res.t, res.X), res.lam
        lams.append(float(lam))
    monkeypatch.undo()
    costs.append(float(res.cost))
    n = accept_prefix(costs, cands)
    assert n >= 3, n
    got = ranks[0]
    assert rel_err(costs[1:n + 1], [float(g["cost"]) for g in got[:n]]) < 1e-10
    assert rel_err(lams[:n], [float(g["lam"]) for g in got[:n]]) < 1e-10
    assert float(got[0]["initial_cost"]) == pytest.approx(costs[0], rel=1e-12)
    assert float(got[-1]["cost"]) < float(got[-1]["initial_cost"])


def test_against_jax_sharded(runs):
    start, prob, _, ranks = runs
    pad = (-len(prob.cam_idx)) % N_RANKS
    padded = prob._replace(cam_idx=np.pad(prob.cam_idx, (0, pad)),
                           pt_idx=np.pad(prob.pt_idx, (0, pad)),
                           uv=np.pad(prob.uv, ((0, pad), (0, 0))),
                           w=np.pad(prob.w, (0, pad)))
    jprob = jba.BAProblem(*map(jnp.asarray, padded))
    mesh = jax_make_mesh(("data",), (N_RANKS,))
    want = jsfm.lm_solve_sharded(mesh, *map(jnp.asarray, start), jprob, iters=ITERS)
    got = ranks[0][-1]
    for k in ("R", "t", "X", "cost", "initial_cost"):
        assert rel_err(np.asarray(getattr(want, k)), np_(got[k])) < 1e-8, k
