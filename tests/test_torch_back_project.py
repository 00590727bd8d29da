"""Port parity: ops/back_project.py (dense, masked and sparse forms) against
the JAX functions, on a synthetic fragment's real projection matrices.

Tolerances: the gather table is float32 here, so features agree to float32
rounding of the projection einsum (atol 1e-5).  With the bf16 table the
package uses by default, both sides round the same inputs to bf16 and agree
to 1e-5 as well, except where a 1-ulp difference in an input crosses a bf16
rounding boundary (atol 1e-2, one bf16 ulp of |feature| <= 4).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deep3dmap_tpu.datasets.synthetic import make_fragment_sample
from deep3dmap_tpu.ops import back_project as J
from deep3dmap_tpu_torch.ops import back_project as T

torch.set_num_threads(2)

DIM, VS, INTERVAL = 12, 0.08, 2


@pytest.fixture(scope="module")
def scene():
    s = make_fragment_sample(seed=1, n_views=3, img_size=(32, 32), n_vox=24,
                             voxel_size=VS)
    rng = np.random.RandomState(0)
    feats = rng.randn(1, 3, 8, 8, 6).astype(np.float32)   # level stride 4*2
    proj = s["proj_matrices"][None, :, 1]                 # (1, V, 4, 4)
    origin = s["vol_origin_partial"][None] + np.float32(0.05)
    return feats, proj, origin


def _j(*a):
    return tuple(jnp.asarray(x) for x in a)


def _t(*a):
    return tuple(torch.from_numpy(np.asarray(x)) for x in a)


@pytest.mark.parametrize("gdt,atol", [(None, 1e-5), ("bfloat16", 1e-2)])
def test_dense(scene, gdt, atol):
    jv, jc = J.back_project_batch(*_j(*scene), DIM, VS, INTERVAL,
                                  gather_dtype=gdt and jnp.dtype(gdt))
    tv, tc = T.back_project_batch(*_t(*scene), DIM, VS, INTERVAL,
                                  gather_dtype=gdt and torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    assert np.asarray(jc).max() >= 2   # some voxels seen by several views
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), atol=atol, rtol=0)


def test_masked(scene):
    rng = np.random.RandomState(3)
    mask = rng.rand(1, DIM, DIM, DIM) < 0.2
    cap = 200   # fewer than the active voxels: exercises truncation
    assert mask.sum() > cap
    jv, jc = J.back_project_masked_batch(*_j(*scene, mask), cap, DIM, VS, INTERVAL)
    tv, tc = T.back_project_masked_batch(*_t(*scene, mask), cap, DIM, VS, INTERVAL)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), atol=1e-5, rtol=0)


def test_sparse_with_padding_slots(scene):
    rng = np.random.RandomState(4)
    idx = rng.randint(0, DIM ** 3, size=(1, 300)).astype(np.int32)
    valid = np.arange(300)[None] < 250
    jf, jc = J.back_project_sparse_batch(*_j(*scene, idx, valid), DIM, VS, INTERVAL)
    tf, tc = T.back_project_sparse_batch(*_t(*scene, idx.astype(np.int64), valid),
                                         DIM, VS, INTERVAL)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    assert (tc.numpy()[0, 250:] == 0).all()
    np.testing.assert_allclose(np.asarray(jf), tf.numpy(), atol=1e-5, rtol=0)
    world_j = J._voxel_world_from_flat(jnp.asarray(idx), DIM, VS,
                                       jnp.asarray(scene[2])[:, None], INTERVAL)
    world_t = T._voxel_world_from_flat(torch.from_numpy(idx.astype(np.int64)),
                                       DIM, VS, torch.from_numpy(scene[2])[:, None],
                                       INTERVAL)
    np.testing.assert_allclose(np.asarray(world_j), world_t.numpy(), atol=1e-6)


def test_nan_pose_does_not_raise_and_matches_jax(scene):
    """One view's projection is NaN: JAX's clip-mode gather carries on with
    NaN features; the port clamps the index and gives the same NaN pattern
    and the same count (a bare index_select raises here and asserts on the
    card)."""
    feats, proj, origin = scene
    proj = proj.copy()
    proj[0, 1] = np.nan
    for gdt in (None, "bfloat16"):
        jv, jc = J.back_project_batch(*_j(feats, proj, origin), DIM, VS, INTERVAL,
                                      gather_dtype=gdt and jnp.dtype(gdt))
        tv, tc = T.back_project_batch(*_t(feats, proj, origin), DIM, VS, INTERVAL,
                                      gather_dtype=gdt and torch.bfloat16)
        np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
        assert np.isnan(tv.numpy()).any()
        np.testing.assert_allclose(np.asarray(jv), tv.numpy(), atol=1e-5, rtol=0,
                                   equal_nan=True)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 2 ** -5)])
def test_packed_gather_vjp_matches_jax(dtype, tol):
    """The per-view scatter backward against ``jax.vjp`` of the JAX
    ``_packed_gather``, in the table's dtype.  bf16: both add the same bf16
    rows, each addition rounded to bf16, in another order where a row is hit
    more than twice (measured: one ulp, 2^-6, at |sum| in [2, 4); tolerance
    two, 2^-5)."""
    import jax

    rs = np.random.RandomState(0)
    S, HW, K, C = 3, 40, 50, 8
    table = rs.randn(S * HW, C).astype(np.float32)
    local = rs.randint(0, HW, (S, K))
    local[0, :5] = 7                     # one row hit five times
    idx = (local + np.arange(S)[:, None] * HW).astype(np.int32)
    cot = rs.randn(S * K, C).astype(np.float32)
    jdt = jnp.dtype(dtype)
    out, vjp = jax.vjp(lambda t: J._packed_gather(t, jnp.asarray(idx),
                                                  jnp.ones((S, K), bool), HW),
                       jnp.asarray(table).astype(jdt))
    (want,) = vjp(jnp.asarray(cot).astype(jdt))
    tdt = getattr(torch, dtype)
    tt = torch.from_numpy(table).to(tdt).requires_grad_()
    got = T._packed_gather(tt, torch.from_numpy(local), HW)
    np.testing.assert_array_equal(np.asarray(out.astype(jnp.float32)),
                                  got.detach().float().numpy())
    got.backward(torch.from_numpy(cot).to(tdt))
    assert tt.grad.dtype == tdt
    np.testing.assert_allclose(tt.grad.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=tol, rtol=0)


def test_packed_gather_clamps_out_of_range_rows():
    """Local indices outside [0, hw) read and write the segment's edge rows,
    never a neighbouring segment's."""
    table = torch.arange(12, dtype=torch.float32).reshape(6, 2).requires_grad_()
    local = torch.tensor([[-5, 1], [2, 99]])
    out = T._packed_gather(table, local, 3)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  table.detach().numpy()[[0, 1, 5, 5]])
    out.sum().backward()
    np.testing.assert_array_equal(table.grad.numpy()[:, 0], [1, 1, 0, 0, 0, 2])
