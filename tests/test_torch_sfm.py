"""The port's SfM geometry (``deep3dmap_tpu_torch/core/sfm/``: se3,
triangulation, two-view geometry with RANSAC, the pose graph, keypoints)
against the JAX package's ``core/sfm/`` on the CPU, in float64 (x64 on for
this module, restored after it).

* so3/se3 maps in three regimes (generic, below 1e-3, within 1e-3 of pi):
  1e-12; the Jacobian of ``so3_log`` at the identity finite and equal;
* multi-view and two-view triangulation: 1e-10;
* the eight-point E up to sign: 1e-9 (eigenvectors have no sign);
* ``essential_ransac`` with JAX's uniforms replayed through the port's draw
  (``_hypothesis_uniforms``): the same inliers, E up to sign 1e-9, with
  30% outliers and with 75% of the slots padding (``-inf`` logits that tie
  in the top-k); ``recover_pose`` on JAX's E: 1e-12;
* ``_edge_linearize``'s Jacobian (``torch.func.vmap(jacfwd)``) against
  ``jax.jacfwd``: 1e-10; ``optimize`` 15 iterations: 1e-8 with the same
  accept sequence while the decisions are above rounding
  (``sfm_helpers.accept_prefix``); ``compose_chain``: 1e-12;
* ``detect_keypoints``: the same indices, ``-inf`` ties included.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep3dmap_tpu.core import sfm as jsfm
from deep3dmap_tpu.core.sfm.pose_graph import PoseGraph as JPoseGraph
from deep3dmap_tpu.core.sfm.pose_graph import _edge_linearize as j_edge_linearize
from deep3dmap_tpu_torch.core import sfm
from deep3dmap_tpu_torch.core.sfm.pose_graph import PoseGraph, _edge_linearize
from deep3dmap_tpu_torch.utils.from_flax import from_jax_tuple
from sfm_helpers import accept_prefix, chain_start, np_, pose_ring, rel_err, ring_scene

# the package re-exports the function ``triangulate`` under the module's name
tri = importlib.import_module("deep3dmap_tpu_torch.core.sfm.triangulate")
pg = importlib.import_module("deep3dmap_tpu_torch.core.sfm.pose_graph")

T = torch.tensor


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def angles(regime, rng, n=24):
    axis = rng.randn(n, 3)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    mag = {"generic": rng.uniform(0.01, 3.0, n),
           "small": np.concatenate([[0.0, 1e-12, 1e-9], 10 ** rng.uniform(-8, -3, n - 3)]),
           "near_pi": np.pi - np.concatenate([[0.0, 1e-9],
                                               10 ** rng.uniform(-8, -3, n - 2)])}[regime]
    return axis * mag[:, None]


@pytest.mark.parametrize("regime", ["generic", "small", "near_pi"])
def test_so3_maps(regime):
    rng = np.random.RandomState(1)
    w = angles(regime, rng)
    R = np.asarray(jsfm.so3_exp(jnp.asarray(w)))
    np.testing.assert_allclose(np_(sfm.so3_exp(T(w))), R, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np_(sfm.so3_log(T(R))), np.asarray(jsfm.so3_log(jnp.asarray(R))),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("regime", ["generic", "small", "near_pi"])
def test_se3_maps(regime):
    rng = np.random.RandomState(2)
    w = angles(regime, rng)
    xi = np.concatenate([rng.randn(len(w), 3), w], -1)
    Ra, ta = jsfm.se3_exp(jnp.asarray(xi))
    Rt, tt = sfm.se3_exp(T(xi))
    np.testing.assert_allclose(np_(Rt), np.asarray(Ra), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np_(tt), np.asarray(ta), rtol=0, atol=1e-12)
    Ra, ta = np.asarray(Ra), np.asarray(ta)
    np.testing.assert_allclose(np_(sfm.se3_log(T(Ra), T(ta))),
                               np.asarray(jsfm.se3_log(jnp.asarray(Ra), jnp.asarray(ta))),
                               rtol=0, atol=1e-12)
    Rb, tb = Ra[::-1].copy(), ta[::-1].copy()
    for jf, tf, args in ((jsfm.se3_compose, sfm.se3_compose, (Ra, ta, Rb, tb)),
                         (jsfm.se3_inverse, sfm.se3_inverse, (Ra, ta)),
                         (jsfm.se3_retract, sfm.se3_retract, (Ra, ta, xi[::-1].copy()))):
        for a, b in zip(jf(*map(jnp.asarray, args)), tf(*map(T, args))):
            np.testing.assert_allclose(np_(b), np.asarray(a), rtol=0, atol=1e-12)
    X = rng.randn(len(w), 5, 3)
    np.testing.assert_allclose(
        np_(sfm.transform_points(T(Ra), T(ta), T(X))),
        np.asarray(jsfm.transform_points(jnp.asarray(Ra), jnp.asarray(ta), jnp.asarray(X))),
        rtol=0, atol=1e-12)


def test_so3_log_jacobian_at_identity():
    """Finite and equal to JAX's: the double-where guard keeps arccos'
    infinite slope out of the tangents (``tests/test_sfm.py:75-80``)."""
    Jj = jax.jit(jax.jacfwd(lambda x: jsfm.so3_log(jsfm.so3_exp(x))))(jnp.zeros(3))
    Jt = torch.func.jacfwd(lambda x: sfm.so3_log(sfm.so3_exp(x)))(
        torch.zeros(3, dtype=torch.float64))
    assert torch.isfinite(Jt).all()
    np.testing.assert_allclose(np_(Jt), np.asarray(Jj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np_(Jt), np.eye(3), rtol=0, atol=1e-12)
    Jj = jax.jit(jax.jacfwd(jsfm.so3_log))(jnp.eye(3))
    Jt = torch.func.jacfwd(sfm.so3_log)(torch.eye(3, dtype=torch.float64))
    assert torch.isfinite(Jt).all()
    np.testing.assert_allclose(np_(Jt), np.asarray(Jj), rtol=0, atol=1e-12)


def test_triangulate():
    rng = np.random.RandomState(3)
    K, Rs, ts, X, prob = ring_scene(rng, n_cams=4, n_pts=48, noise=0.5)
    P, V = X.shape[0], Rs.shape[0]
    uv = prob.uv.reshape(V, P, 2).transpose(1, 0, 2)
    mask = (rng.rand(P, V) < 0.8).astype(np.float64)
    mask[:3, 1:] = 0.0                      # under-constrained: zeros
    args = (np.broadcast_to(K[None], (P, V, 4)), np.broadcast_to(Rs[None], (P, V, 3, 3)),
            np.broadcast_to(ts[None], (P, V, 3)), uv, mask)
    Xj = np.asarray(jax.jit(jsfm.triangulate)(*args))
    Xt = np_(sfm.triangulate(*(T(np.ascontiguousarray(a)) for a in args)))
    assert rel_err(Xj, Xt) < 1e-10 and np.all(Xt[:3] == 0)
    two = (K[0], Rs[0], ts[0], K[1], Rs[1], ts[1], prob.uv[:P], prob.uv[P:2 * P])
    Xj = np.asarray(jax.jit(jsfm.triangulate_two_view)(*two))
    Xt = np_(sfm.triangulate_two_view(*map(T, two)))
    assert rel_err(Xj, Xt) < 1e-10


def two_view(rng, n=200, outliers=0.3, noise=0.0):
    K, Rs, ts, X, prob = ring_scene(rng, n_cams=2, n_pts=n, noise=noise)
    uv1, uv2 = prob.uv[:n].copy(), prob.uv[n:].copy()
    bad = rng.rand(n) < outliers
    uv2[bad] += rng.randn(bad.sum(), 2) * 40 + 20
    x1 = np.asarray(jsfm.normalize_points(jnp.asarray(uv1), jnp.asarray(K[0])))
    x2 = np.asarray(jsfm.normalize_points(jnp.asarray(uv2), jnp.asarray(K[1])))
    np.testing.assert_allclose(np_(sfm.normalize_points(T(uv2), T(K[1]))), x2, rtol=0,
                               atol=1e-15)
    return Rs, ts, x1, x2, bad


def same_up_to_sign(Ej, Et, tol):
    Ej, Et = np.asarray(Ej), np_(Et)
    s = np.sign(np.sum(Ej * Et))
    return np.abs(Ej - s * Et).max() < tol


def test_essential_eight_point_and_sampson():
    rng = np.random.RandomState(4)
    _, _, x1, x2, _ = two_view(rng, n=64, outliers=0.0, noise=0.3)
    w = rng.uniform(0.2, 1.0, 64)
    Ej = jax.jit(jsfm.essential_eight_point)(x1, x2, w)
    Et = sfm.essential_eight_point(T(x1), T(x2), T(w))
    assert same_up_to_sign(Ej, Et, 1e-9)
    dj = np.asarray(jsfm.sampson_distance(Ej, jnp.asarray(x1), jnp.asarray(x2)))
    dt = np_(sfm.sampson_distance(T(np.asarray(Ej)), T(x1), T(x2)))
    assert rel_err(dj, dt) < 1e-12


def replay_uniforms(monkeypatch, key, H, N):
    """Feed ``jax.random.uniform(key, (H, N), minval=1e-9, maxval=1.0)``,
    JAX's draw in ``essential_ransac``, through the port's draw."""
    g = np.asarray(jax.random.uniform(key, (H, N), minval=1e-9, maxval=1.0))

    def draw(generator, n_hypotheses, like):
        assert (n_hypotheses, like.shape[0]) == g.shape
        return torch.tensor(g, dtype=like.dtype, device=like.device)
    monkeypatch.setattr(tri, "_hypothesis_uniforms", draw)


@pytest.mark.parametrize("case", ["outliers30", "padded75"])
def test_essential_ransac_replayed(monkeypatch, case):
    rng = np.random.RandomState(5)
    if case == "outliers30":
        Rs, ts, x1, x2, bad = two_view(rng, n=200, outliers=0.3)
        w, H, thresh, key = np.ones(200), 256, 1e-4, jax.random.PRNGKey(0)
    else:   # tests/test_sfm.py:320-336: 64 real slots, 192 of padding
        Rs, ts, x1, x2, bad = two_view(rng, n=64, outliers=0.0)
        x1, x2 = np.pad(x1, ((0, 192), (0, 0))), np.pad(x2, ((0, 192), (0, 0)))
        w, H, thresh, key = np.pad(np.ones(64), (0, 192)), 64, 1e-4, jax.random.PRNGKey(3)
    Ej, inl_j = jax.jit(lambda a, b, k, ww: jsfm.essential_ransac(
        a, b, k, w=ww, n_hypotheses=H, thresh=thresh))(x1, x2, key, w)
    replay_uniforms(monkeypatch, key, H, len(w))
    Et, inl_t = sfm.essential_ransac(T(x1), T(x2), None, w=T(w), n_hypotheses=H, thresh=thresh)
    np.testing.assert_array_equal(np_(inl_t), np.asarray(inl_j))
    assert same_up_to_sign(Ej, Et, 1e-9)
    inl = np_(inl_t)
    assert inl[:len(bad)][~bad].mean() > 0.95 and not inl[len(bad):].any()
    # recover_pose on the same E and inliers: the same candidate
    sel = np.asarray(inl_j)
    Rj, tj = jax.jit(jsfm.recover_pose)(Ej, x1[sel], x2[sel])
    Rt, tt = sfm.recover_pose(T(np.asarray(Ej)), T(x1[sel]), T(x2[sel]))
    np.testing.assert_allclose(np_(Rt), np.asarray(Rj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np_(tt), np.asarray(tj), rtol=0, atol=1e-12)
    Rg, tg = sfm.relative_pose(*map(T, (Rs[0], ts[0], Rs[1], ts[1])))
    rot_err = np.degrees(np.linalg.norm(np_(sfm.so3_log(Rt @ Rg.T))))
    assert rot_err < 1.0


def test_recover_pose_weights():
    """The weighted score (w = 0 slots do not vote) picks the same of the
    four candidates."""
    rng = np.random.RandomState(6)
    _, _, x1, x2, _ = two_view(rng, n=96, outliers=0.0, noise=0.2)
    w = (rng.rand(96) < 0.7).astype(np.float64)
    Ej = jax.jit(jsfm.essential_eight_point)(x1, x2)
    Rj, tj = jax.jit(jsfm.recover_pose)(Ej, x1, x2, w)
    Rt, tt = sfm.recover_pose(T(np.asarray(Ej)), T(x1), T(x2), T(w))
    np.testing.assert_allclose(np_(Rt), np.asarray(Rj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np_(tt), np.asarray(tj), rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def graph():
    rng = np.random.RandomState(7)
    Rg, tg, g = pose_ring(rng, N=16, loops=((0, -1), (3, 11)))
    R0, t0 = chain_start(Rg, tg, g)
    return R0, t0, g


def test_edge_linearize_jacobian(graph):
    R0, t0, g = graph
    args = (R0[g.i], t0[g.i], R0[g.j], t0[g.j], g.Rz, g.tz)
    rj, Jij, Jjj = jax.jit(jax.vmap(j_edge_linearize))(*args)
    rt, Jit, Jjt = torch.func.vmap(_edge_linearize)(*map(T, args))
    for a, b in ((rj, rt), (Jij, Jit), (Jjj, Jjt)):
        assert rel_err(a, np_(b)) < 1e-10
    rr = sfm.edge_residual(*map(T, args))
    assert rel_err(rj, np_(rr)) < 1e-12


def test_pose_graph_optimize(graph, monkeypatch):
    R0, t0, g = graph
    jg = JPoseGraph(*map(jnp.asarray, g))
    run_j = jax.jit(lambda R, t, n: jsfm.optimize(R, t, jg, iters=n))
    jc = [float(run_j(R0, t0, n)[2]) for n in range(16)]        # cost after n iterations
    Rj, tj, cj, c0j = run_j(R0, t0, 15)

    cands = []
    orig = pg.graph_cost

    def spy(R, t, gg):
        c = orig(R, t, gg)
        cands.append(float(c))
        return c
    monkeypatch.setattr(pg, "graph_cost", spy)
    tgph = from_jax_tuple(PoseGraph, g, device="cpu")
    assert tgph.i.dtype == torch.int64 and tgph.w.dtype == torch.float64
    Rt, tt, ct, c0t = sfm.optimize(T(R0), T(t0), tgph, iters=15)
    c0, cands = cands[0], cands[1:]
    costs, accepts = [c0], []
    for new in cands:
        accepts.append(new < costs[-1])
        costs.append(new if accepts[-1] else costs[-1])
    n = accept_prefix(costs[:-1], cands)
    assert n >= 3, n
    accepts_j = [b < a for a, b in zip(jc[:-1], jc[1:])]
    assert accepts[:n] == accepts_j[:n]
    assert rel_err(jc[:n + 1], costs[:n + 1]) < 1e-10
    assert float(ct) < 0.5 * float(c0t)
    assert abs(float(ct) - float(cj)) <= 1e-8 * float(cj)
    assert abs(float(c0t) - float(c0j)) <= 1e-12 * float(c0j)
    assert rel_err(Rj, np_(Rt)) < 1e-8 and rel_err(tj, np_(tt)) < 1e-8
    np.testing.assert_array_equal(np_(Rt[0]), R0[0])            # the anchor


def test_compose_chain_and_odometry_graph(graph):
    _, _, g = graph
    Rj, tj = jax.jit(jsfm.compose_chain)(g.Rz[:15], g.tz[:15])
    Rt, tt = sfm.compose_chain(T(g.Rz[:15]), T(g.tz[:15]))
    np.testing.assert_allclose(np_(Rt), np.asarray(Rj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np_(tt), np.asarray(tj), rtol=0, atol=1e-12)
    og = sfm.odometry_graph(T(g.Rz[:15]), T(g.tz[:15]))
    jog = jsfm.odometry_graph(jnp.asarray(g.Rz[:15]), jnp.asarray(g.tz[:15]))
    for a, b in zip(jog, og):
        np.testing.assert_array_equal(np_(b), np.asarray(a))
    # exact measurements: both costs are rounding (~1e-29)
    cj = jax.jit(jsfm.graph_cost)(Rj, tj, jog)
    assert abs(float(sfm.graph_cost(Rt, tt, og)) - float(cj)) <= 1e-20
    Rg, tg = np.asarray(Rj)[::-1].copy(), np.asarray(tj)[::-1].copy()
    cj = jax.jit(jsfm.graph_cost)(Rg, tg, jog)
    assert abs(float(sfm.graph_cost(T(Rg), T(tg), og)) - float(cj)) <= 1e-12 * float(cj)


def smooth_image(rng, H, W, dtype):
    """A random texture smoothed by a 5x5 box (``tests/test_sfm.py:268-283``)."""
    img = rng.rand(H, W)
    pad = np.pad(img, 2)
    out = sum(pad[dy:dy + H, dx:dx + W] for dy in range(5) for dx in range(5)) / 25.0
    return out.astype(dtype)


def test_detect_keypoints_float64():
    """More keypoints asked for than there are maxima: the tail is ``-inf``
    scores, ordered by index on both sides."""
    img = smooth_image(np.random.RandomState(8), 48, 64, np.float64)
    kj = jax.jit(lambda x: jsfm.detect_keypoints(x, k=256))(img)
    kt = sfm.detect_keypoints(T(img), k=256)
    n_inf = int(np.isinf(np.asarray(kj.score)).sum())
    assert 0 < n_inf < 256
    np.testing.assert_array_equal(np_(kt.xy), np.asarray(kj.xy))
    np.testing.assert_array_equal(np_(kt.valid), np.asarray(kj.valid))
    np.testing.assert_allclose(np_(kt.score), np.asarray(kj.score), rtol=1e-12, atol=0)
