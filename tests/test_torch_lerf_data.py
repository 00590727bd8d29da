"""LERF's ray datamanager in the port against JAX's, on the CPU.

Both sides get the same encoders: JAX's seeded compact CLIP towers (the
``image``/``text`` npz both ``CLIPEncoder``s read) and JAX's seeded DINO
ViT (an ``import_weights`` layout npz).  The crop geometry is equal; the
embedding grids and DINO maps agree to float32 rounding of the encoders
(``ATOL`` 1e-5, 2e-5 for DINO); with JAX's grids and maps handed to the
port, every batch is JAX's bit for bit (the same ``RandomState`` draws in
the same order, the same queries).
"""
import numpy as np
import pytest
import torch

import jax

from deep3dmap_tpu.datasets.lerf_rays import LERFRayDataset as JRays
from deep3dmap_tpu.models.modulars.clip_encoder import CLIPEncoder as JEnc
from deep3dmap_tpu.models.modulars.dino_vit import DinoExtractor as JDino
from deep3dmap_tpu_torch.datasets.builder import build_dataloader
from deep3dmap_tpu_torch.datasets.lerf_rays import LERFRayDataset
from deep3dmap_tpu_torch.models.modulars.clip_encoder import CLIPEncoder

torch.set_num_threads(2)
ATOL = 1e-5
KW = dict(rays_per_batch=96, n_batches=3, clip_n_dims=64, dino_n_dims=32,
          tile_size_range=(0.2, 0.5), tile_size_res=3, seed=5)


def _tree(x):
    return np.array(jax.tree_util.tree_map(np.asarray, x), dtype=object)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("lerf_data")
    jenc = JEnc(embed_dim=64, seed=1)
    clip = str(d / "clip.npz")
    np.savez(clip, image=_tree(jenc.image_params), text=_tree(jenc.text_params))
    jd = JDino(cfg=dict(dim=32, heads=1))
    jd._ensure_params(jd.preprocess(np.zeros((1, 32, 32, 3), np.float32)))
    dino = str(d / "dino.npz")
    np.savez(dino, params=_tree(jd.params), meta=np.array(jd.cfg, dtype=object))
    jds = JRays(image_encoder=jenc, dino_npz=dino, **KW)
    tds = LERFRayDataset(image_encoder=CLIPEncoder(embed_dim=64, weights_path=clip,
                                                   device="cpu"),
                         dino_npz=dino, device="cpu", **KW)
    jds._precompute()
    tds._precompute()
    return jds, tds


def test_images_and_crop_geometry(pair):
    jds, tds = pair
    for a, b in zip(jds.base.images, tds.base.images):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jds.base.intrinsics, tds.base.intrinsics)
    np.testing.assert_array_equal(np.stack(jds.base.poses), np.stack(tds.base.poses))
    np.testing.assert_array_equal(jds._pyramid.tile_sizes, tds._pyramid.tile_sizes)
    for a, b in zip(jds._pyramid.levels, tds._pyramid.levels):
        assert (a.k, a.stride, a.pad) == (b.k, b.stride, b.pad)
        np.testing.assert_array_equal(a.center_r, b.center_r)
        np.testing.assert_array_equal(a.center_c, b.center_c)
        assert a.data.shape == b.data.shape
        assert b.n_crops == len(a.center_r) * len(a.center_c)


def test_embeddings_agree(pair):
    jds, tds = pair
    for a, b in zip(jds._pyramid.levels, tds._pyramid.levels):
        np.testing.assert_allclose(b.data, a.data, atol=ATOL)
    assert tds.dino_pretrained and jds.dino_pretrained
    np.testing.assert_allclose(tds._dino_maps, jds._dino_maps, atol=2e-5)


def test_batches_equal_jax(pair):
    """JAX's grids and maps in the port: the batches are JAX's bit for bit,
    through ``build_dataloader``, which passes the iterable through."""
    jds, tds = pair
    saved = [lv.data for lv in tds._pyramid.levels], tds._dino_maps
    try:
        for a, b in zip(jds._pyramid.levels, tds._pyramid.levels):
            b.data = a.data
        tds._dino_maps = jds._dino_maps
        loader = build_dataloader(tds, samples_per_gpu=1, shuffle=True, seed=0)
        assert loader is tds and len(loader) == KW["n_batches"]
        got, want = list(loader), list(jds)
        assert len(got) == len(want) == KW["n_batches"]
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        rs_j, rs_t = np.random.RandomState(9), np.random.RandomState(9)
        idx = np.zeros(50, np.int64)
        rows, cols = (rs_j.rand(2, 50) * 31).astype(np.float32)
        rs_t.rand(2, 50)
        e1, s1 = jds._pyramid.sample_random_scales(rs_j, idx, rows, cols)
        e2, s2 = tds._pyramid.sample_random_scales(rs_t, idx, rows, cols)
        np.testing.assert_array_equal(e1, e2)
        np.testing.assert_array_equal(s1, s2)
    finally:
        for lv, data in zip(tds._pyramid.levels, saved[0]):
            lv.data = data
        tds._dino_maps = saved[1]
