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
