"""Port parity: ops/block_sparse.py, every function against its JAX twin.

Index bookkeeping must agree exactly (identical ``BlockSet`` ids, valid flags
and ``slot_of``); data movement is a pure copy, so those outputs agree
exactly too.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deep3dmap_tpu.ops import block_sparse as J
from deep3dmap_tpu_torch.ops import block_sparse as T

torch.set_num_threads(2)

NB, BS, B = 4, 8, 2


def _mask(rng, p, nb=NB):
    m = rng.rand(B, nb, nb, nb) < p
    m[0, 0, 0, 0] = True   # block 0 active in sample 0 ...
    m[1, 0, 0, 0] = False  # ... and inactive in sample 1 (padding ids are 0)
    return m


def _sets(m, maxb, bs=BS):
    return J.select_blocks(jnp.asarray(m), maxb, bs), T.select_blocks(
        torch.from_numpy(m), maxb, bs)


def _eq_set(jset, tset):
    np.testing.assert_array_equal(np.asarray(jset.ids), tset.ids.numpy())
    np.testing.assert_array_equal(np.asarray(jset.valid), tset.valid.numpy())
    np.testing.assert_array_equal(np.asarray(jset.slot_of), tset.slot_of.numpy())
    assert (jset.nb, jset.bs) == (tset.nb, tset.bs)


@pytest.mark.parametrize("p,maxb", [(0.2, 32), (0.6, 16), (0.0, 8)])
def test_select_blocks_identical(rng, p, maxb):
    """Under and over capacity, and empty: the first maxb active ids in
    ascending order, padding 0, padding writes to the scratch slot."""
    _eq_set(*_sets(_mask(rng, p), maxb))


def test_first_nonzero_matches_jnp_nonzero(rng):
    m = rng.rand(3, 200) < 0.3
    ids, n = T.first_nonzero(torch.from_numpy(m), 40)
    for b in range(3):
        (want,) = jnp.nonzero(jnp.asarray(m[b]), size=40, fill_value=0)
        np.testing.assert_array_equal(ids[b].numpy(), np.asarray(want))
        assert int(n[b]) == m[b].sum()


def test_block_mask_from_voxels(rng):
    vox = rng.rand(B, 16, 16, 16) < 0.01
    np.testing.assert_array_equal(
        np.asarray(J.block_mask_from_voxels(jnp.asarray(vox), 4)),
        T.block_mask_from_voxels(torch.from_numpy(vox), 4).numpy())


def test_dense_block_roundtrips(rng):
    jset, tset = _sets(_mask(rng, 0.5), 20)
    d, C = NB * BS, 3
    vol = rng.randn(B, d, d, d, C).astype(np.float32)
    jb = J.dense_to_blocks(jnp.asarray(vol), jset)
    tb = T.dense_to_blocks(torch.from_numpy(vol), tset)
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    blocks = rng.randn(*tb.shape).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(J.blocks_to_dense(jnp.asarray(blocks), jset, fill=1.0)),
        T.blocks_to_dense(torch.from_numpy(blocks), tset, fill=1.0).numpy())
    np.testing.assert_array_equal(
        np.asarray(J.blocks_to_dense_over(jnp.asarray(blocks), jset,
                                          jnp.asarray(vol))),
        T.blocks_to_dense_over(torch.from_numpy(blocks), tset,
                               torch.from_numpy(vol)).numpy())


@pytest.mark.parametrize("bs", [8, 4, 2])
def test_gather_halo(rng, bs):
    """At every block side the UNet uses (8 -> 4 -> 2)."""
    jset, tset = _sets(_mask(rng, 0.5), 24, bs=bs)
    blocks = rng.randn(B, 24, bs, bs, bs, 5).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(J.gather_halo(jnp.asarray(blocks), jset)),
        T.gather_halo(torch.from_numpy(blocks), tset).numpy())


def test_child_mask_and_parent_octants(rng):
    jset, tset = _sets(_mask(rng, 0.4), 12)
    occ = rng.rand(B, 12, BS, BS, BS) < 0.05
    jc = J.child_block_mask(jnp.asarray(occ), jset)
    tc = T.child_block_mask(torch.from_numpy(occ), tset)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())

    jchild, tchild = _sets(np.asarray(jc), 40)
    _eq_set(jchild, tchild)
    C = 4
    parent = rng.randn(B, 12, BS, BS, BS, C).astype(np.float32)
    fill = np.array([0.0, 1.0, 0.0, 0.0], np.float32)
    np.testing.assert_array_equal(
        np.asarray(J.gather_parent_octants(jnp.asarray(parent), jset, jchild,
                                           fill=jnp.asarray(fill))),
        T.gather_parent_octants(torch.from_numpy(parent), tset, tchild,
                                fill=torch.from_numpy(fill)).numpy())


def test_block_voxel_indices(rng):
    jset, tset = _sets(_mask(rng, 0.3), 10)
    np.testing.assert_array_equal(np.asarray(J.block_voxel_indices(jset)),
                                  T.block_voxel_indices(tset).numpy())
