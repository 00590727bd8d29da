"""The port's SfM layer against the JAX package's in float32 (JAX's
default), on the CPU, and the port's ``tools/benchmark_ba.py`` against the
JAX tool.

* the normal blocks: 1e-5 relative; ``lm_solve``'s final cost: 1e-4;
* ``detect_keypoints``: the same index sets under the near-tie rule (the
  two sides' convolutions round differently in float32, so two finite
  responses within 1e-6 relative may trade places, and a keypoint may
  trade with a neighbour of nearly the same response); ``extract_descriptors``
  1e-6; ``match_descriptors``: the same ``idx2`` and ``valid``;
* the tool on ``--cams 6 --pts 64 --obs-per-pt 4 --iters 5 --reps 1``: the
  JAX tool's fields, its problem equal to the JAX tool's, its final cost
  within 1e-4 of JAX's ``lm_solve`` on that problem; more views per point
  than cameras raise (the JAX tool clamps them: ROADMAP.md Queue 3).
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep3dmap_tpu.core import sfm as jsfm
from deep3dmap_tpu.core.sfm import ba as jba
from deep3dmap_tpu_torch.core import sfm
from deep3dmap_tpu_torch.core.sfm import ba
from deep3dmap_tpu_torch.tools import benchmark_ba
from deep3dmap_tpu_torch.utils.from_flax import from_jax_tuple
from sfm_helpers import np_, perturb, rel_err, ring_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = np.float32
NEAR_TIE = 1e-6


def f32(tree):
    return type(tree)(*(a.astype(F32) if a.dtype == np.float64 else a for a in tree))


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(21)
    K, Rs, ts, X, prob = ring_scene(rng, n_cams=6, n_pts=64, noise=0.5)
    R0, t0, X0 = (a.astype(F32) for a in perturb(rng, Rs, ts, X))
    prob = f32(prob)
    return (R0, t0, X0), jba.BAProblem(*map(jnp.asarray, prob)), \
        from_jax_tuple(ba.BAProblem, prob, device="cpu")


def test_normal_blocks_float32(problem):
    (R0, t0, X0), jprob, tprob = problem
    bj = jax.jit(lambda R, t, X: jba._normal_blocks(R, t, X, jprob, None))(R0, t0, X0)
    bt = ba._normal_blocks(*map(torch.tensor, (R0, t0, X0)), tprob, None)
    assert bt[0].dtype == torch.float32
    for a, b in zip(bj, bt):
        assert rel_err(a, np_(b)) < 1e-5


def test_lm_solve_float32_cost(problem):
    (R0, t0, X0), jprob, tprob = problem
    rj = jax.jit(lambda R, t, X: jsfm.lm_solve(R, t, X, jprob, iters=20))(R0, t0, X0)
    rt = sfm.lm_solve(*map(torch.tensor, (R0, t0, X0)), tprob, iters=20)
    assert rt.cost.dtype == torch.float32
    assert abs(float(rt.cost) - float(rj.cost)) <= 1e-4 * float(rj.cost)
    assert abs(float(rt.initial_cost) - float(rj.initial_cost)) <= 1e-5 * float(rj.initial_cost)
    assert float(rt.cost) < 1e-2 * float(rt.initial_cost)


def smooth_image(rng, H, W):
    img = rng.rand(H, W)
    pad = np.pad(img, 2)
    return (sum(pad[dy:dy + H, dx:dx + W] for dy in range(5) for dx in range(5)) / 25.0
            ).astype(F32)


@pytest.fixture(scope="module")
def images():
    img = smooth_image(np.random.RandomState(22), 96, 128)
    return img, np.roll(img, 6, axis=1)


def near_tie(resp, a, b, k_th):
    """Pixel ``a`` and ``b`` of the response map hold equal responses within
    the float32 rounding of the two convolutions, or pixel ``a`` sits at
    the cut (the k-th score) within it."""
    ra, rb = resp.reshape(-1)[a], resp.reshape(-1)[b]
    scale = max(abs(ra), abs(rb), 1e-12)
    return abs(ra - rb) <= NEAR_TIE * scale or abs(ra - k_th) <= NEAR_TIE * abs(k_th)


def test_detect_keypoints_float32(images):
    img = images[0]
    W = img.shape[1]
    kj = jax.jit(lambda x: jsfm.detect_keypoints(x, k=256))(img)
    kt = sfm.detect_keypoints(torch.tensor(img), k=256)
    resp = np.asarray(jax.jit(jsfm.harris_response)(img))
    ij = np.asarray(kj.xy)[:, 1] * W + np.asarray(kj.xy)[:, 0]
    it = np_(kt.xy)[:, 1] * W + np_(kt.xy)[:, 0]
    sj, st = np.asarray(kj.score), np_(kt.score)
    finite = np.isfinite(sj)
    assert 0 < finite.sum() < 256                          # -inf ties in the tail
    k_th = sj[finite].min()
    only_j, only_t = sorted(set(ij[finite]) - set(it)), sorted(set(it[np.isfinite(st)]) - set(ij))
    assert len(only_j) == len(only_t)
    assert all(near_tie(resp, a, b, k_th) for a, b in zip(only_j, only_t))
    # where the lists agree position by position, so do the scores
    same = ij == it
    np.testing.assert_allclose(st[same & finite], sj[same & finite], rtol=NEAR_TIE, atol=0)
    np.testing.assert_array_equal(np.isinf(st), np.isinf(sj))
    np.testing.assert_array_equal(np_(kt.valid)[same], np.asarray(kj.valid)[same])


def test_descriptors_and_matches_float32(images):
    """The same keypoints (JAX's) through both sides' descriptors, the same
    descriptors (JAX's) through both sides' matcher; then ``match_images``
    whole."""
    img, img2 = images
    kps = [jax.jit(lambda x: jsfm.detect_keypoints(x, k=128))(im) for im in (img, img2)]
    tkps = [from_jax_tuple(sfm.Keypoints, kp, device="cpu") for kp in kps]
    dj = [jax.jit(jsfm.extract_descriptors)(im, kp) for im, kp in zip((img, img2), kps)]
    for im, kp, d in zip((img, img2), tkps, dj):
        dt = sfm.extract_descriptors(torch.tensor(im), kp)
        np.testing.assert_allclose(np_(dt), np.asarray(d), rtol=0, atol=1e-6)
    mj = jax.jit(jsfm.match_descriptors)(dj[0], dj[1], kps[0].valid, kps[1].valid)
    mt = sfm.match_descriptors(torch.tensor(np.asarray(dj[0])), torch.tensor(np.asarray(dj[1])),
                               tkps[0].valid, tkps[1].valid)
    np.testing.assert_array_equal(np_(mt.idx2), np.asarray(mj.idx2))
    np.testing.assert_array_equal(np_(mt.valid), np.asarray(mj.valid))
    np.testing.assert_array_equal(np_(mt.idx1), np.arange(128))
    np.testing.assert_allclose(np_(mt.score), np.asarray(mj.score), rtol=0, atol=1e-6)
    k1, k2, m = sfm.match_images(torch.tensor(img), torch.tensor(img2), k=128)
    sel = np_(m.valid)
    assert sel.sum() >= 10
    dx = np_(k2.xy)[np_(m.idx2)[sel], 0] - np_(k1.xy)[sel, 0]
    assert np.mean(np.abs(((dx - 6) + 64) % 128 - 64) <= 1) > 0.7


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_benchmark_ba", os.path.join(ROOT, "tools", "benchmark_ba.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL_SIZE = (6, 64, 4)           # cameras, points, views per point
JAX_FIELDS = {"report", "cams", "points", "observations", "lm_iters_per_s", "obs_per_s",
              "initial_cost", "final_cost", "device"}


def test_benchmark_ba_tool(capsys):
    out = benchmark_ba.main(["--device", "cpu", "--cams", "6", "--pts", "64", "--obs-per-pt",
                             "4", "--iters", "5", "--reps", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out and set(out) == JAX_FIELDS | {"power_limit_w"}
    assert out["device"] == "cpu" and out["power_limit_w"] is None
    assert out["observations"] == 64 * 4 and out["lm_iters_per_s"] > 0

    # the problem is the JAX tool's, built from the same draws
    rng = np.random.RandomState(0)
    K, Rs, ts, X, prob = benchmark_ba.make_problem(rng, *TOOL_SIZE, device="cpu")
    R0, t0, X0 = benchmark_ba.perturbed_start(rng, Rs, ts, X)
    jK, jRs, jts, jX, jprob = jax_tool().make_problem(np.random.RandomState(0), *TOOL_SIZE,
                                                      jnp.float32)
    np.testing.assert_array_equal(np_(prob.cam_idx), np.asarray(jprob.cam_idx))
    np.testing.assert_array_equal(np_(prob.pt_idx), np.asarray(jprob.pt_idx))
    np.testing.assert_array_equal(np_(prob.cam_fixed), np.asarray(jprob.cam_fixed))
    np.testing.assert_allclose(np_(prob.uv), np.asarray(jprob.uv), rtol=0, atol=1e-3)
    np.testing.assert_allclose(np_(Rs), np.asarray(jRs), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np_(X), np.asarray(jX))
    # its final cost against JAX's lm_solve on the port's problem
    jp = jba.BAProblem(*(jnp.asarray(np_(a)) for a in prob))
    rj = jax.jit(lambda R, t, Xp: jsfm.lm_solve(R, t, Xp, jp, iters=5))(
        np_(R0), np_(t0), np_(X0))
    assert abs(out["final_cost"] - float(rj.cost)) <= 1e-4 * float(rj.cost)
    assert abs(out["initial_cost"] - float(rj.initial_cost)) <= 1e-5 * float(rj.initial_cost)


def test_benchmark_ba_views_past_the_cameras():
    """Each point is seen by ``obs_per_pt`` consecutive cameras: more than
    there are raises in the port.  The JAX tool builds camera indices past
    the last camera (``cam_idx`` up to 7 of 6), which its gathers clamp and
    its ``segment_sum`` drops."""
    with pytest.raises(ValueError, match="obs_per_pt"):
        benchmark_ba.make_problem(np.random.RandomState(0), 6, 64, 8, device="cpu")
    *_, jprob = jax_tool().make_problem(np.random.RandomState(0), 6, 64, 8, jnp.float32)
    assert int(np.asarray(jprob.cam_idx).max()) == 7
