"""LERF's encoders in the port against JAX's, on the CPU: CLIPViT and
DinoViT built from one synthetic torch state dict through both sides'
importers, the importers' ``.npz`` files key for key, the BPE tokenizer on
a vocab written in ``tmp_path``, and the port's ``import_weights`` CLI.

Tolerances: the ``.npz`` trees and the tokens are equal; the encoders'
float32 outputs agree to ``ATOL`` 1e-5 (O(1) values, matmul summation
orders), the DINO keys to 2e-5 (the bicubic position embedding adds its
own rounding, ~4e-6 on its own).
"""
import gzip

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep3dmap_tpu.models.modulars import clip_vit as jcv
from deep3dmap_tpu.models.modulars import dino_vit as jdv
from deep3dmap_tpu.utils import torch_import as jti
from deep3dmap_tpu_torch.datasets.synthetic import (seeded_clip_state_dict,
                                                    seeded_dino_state_dict)
from deep3dmap_tpu_torch.models.modulars import clip_vit as tcv
from deep3dmap_tpu_torch.models.modulars import dino_vit as tdv
from deep3dmap_tpu_torch.tools import import_weights as import_cli
from deep3dmap_tpu_torch.utils import torch_import as tti

torch.set_num_threads(2)
ATOL = 1e-5
CLIP_KW = dict(width=64, layers=2, patch=8, image=32, text_width=32, text_layers=2,
               embed=48, vocab=128, ctx=16)
DINO_KW = dict(dim=384, depth=3, patch=8, grid=4)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.fixture(scope="module")
def clip_pair():
    sd = seeded_clip_state_dict(1, **CLIP_KW)
    vc, tc, vp, tp, scale = jti.import_clip(sd)
    tvc, ttc, tvp, ttp, tscale = tti.import_clip(sd)
    assert (vc, tc, scale) == (tvc, ttc, tscale)
    return sd, jcv.CLIPViT(vc, tc, vision_params=vp, text_params=tp, logit_scale=scale), \
        tcv.CLIPViT(tvc, ttc, vision_params=tvp, text_params=ttp, logit_scale=tscale,
                    device="cpu"), (vp, tp, tvp, ttp)


def test_clip_importer_trees_equal(clip_pair):
    sd, _, _, (vp, tp, tvp, ttp) = clip_pair
    assert tti.clip_cfg_from_state_dict(sd) == jti.clip_cfg_from_state_dict(sd)
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, vp), tvp)
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, tp), ttp)
    bad = dict(sd)
    bad.pop("visual.ln_post.bias")
    with pytest.raises(KeyError):
        tti.import_clip(bad)


@pytest.mark.parametrize("size", [32, 48])
def test_clip_vit_matches(clip_pair, size):
    """At the checkpoint's 32² and at 48² (the bilinear position embedding)."""
    _, jm, tm, _ = clip_pair
    rs = np.random.RandomState(size)
    img = rs.rand(3, size, size, 3).astype(np.float32)
    want = np.asarray(jm.encode_image(jm.preprocess(img)))
    got = tm.encode_image(tm.preprocess(img)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    toks = np.zeros((3, 16), np.int32)
    toks[0, :3] = [126, 5, 127]
    toks[1, :5] = [126, 9, 11, 40, 127]
    toks[2, :2] = [126, 127]
    np.testing.assert_allclose(tm.encode_text(toks).numpy(),
                               np.asarray(jm.encode_text(toks)), atol=ATOL)


def test_clip_encoder_on_imported_weights(clip_pair, tmp_path):
    """A LERF ``clip_weights`` file: both ``CLIPEncoder``s switch to the
    full ViT and hash the words into its vocab (one process)."""
    from deep3dmap_tpu.models.modulars.clip_encoder import CLIPEncoder as JEnc
    from deep3dmap_tpu_torch.models.modulars.clip_encoder import CLIPEncoder as TEnc

    sd = clip_pair[0]
    path = str(tmp_path / "clip.npz")
    np.savez(path, **tti.import_npz_entries("clip", sd))
    j, m = JEnc(embed_dim=48, weights_path=path), TEnc(embed_dim=48, weights_path=path,
                                                       device="cpu")
    assert m._vit is not None
    j.set_positives(["red chair"])
    m.set_positives(["red chair"])
    np.testing.assert_allclose(m.pos_embeds.numpy(), np.asarray(j.pos_embeds), atol=ATOL)
    np.testing.assert_allclose(m.neg_embeds.numpy(), np.asarray(j.neg_embeds), atol=ATOL)


def _write_bpe(path):
    merges = ["#version: 0.2", "l o", "lo w</w>", "e r</w>", "lo w", "low e", "c h", "ch a"]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(merges) + "\n")


def test_bpe_tokenizer_matches(tmp_path):
    path = str(tmp_path / "bpe.txt.gz")
    _write_bpe(path)
    texts = ["low", "lower", "Lower  chairs!", "a &amp; b's 42", "naïve café"]
    j, m = jcv.BPETokenizer(path, ctx_len=12), tcv.BPETokenizer(path, ctx_len=12)
    np.testing.assert_array_equal(m(texts), j(texts))
    assert m(["low"])[0, 1] == m.encoder["low</w>"]


@pytest.fixture(scope="module")
def dino_pair():
    sd = seeded_dino_state_dict(2, **DINO_KW)
    cfg, params = jti.import_dino(sd)
    tcfg, tparams = tti.import_dino(dict(sd, **{"head.weight": np.zeros((3, 384), np.float32)}))
    assert cfg == tcfg
    return sd, cfg, params, tparams


def test_dino_importer_trees_equal(dino_pair):
    sd, cfg, params, tparams = dino_pair
    assert tti.dino_cfg_from_state_dict(sd) == jti.dino_cfg_from_state_dict(sd) == cfg
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, params), tparams)


@pytest.mark.parametrize("hw,facet", [((32, 32), "key"), ((40, 56), "key"),
                                      ((32, 32), "token"), ((24, 24), "value")])
def test_dino_vit_matches(dino_pair, hw, facet):
    """The layer-2 facets at the checkpoint's 4² grid and at 5x7 and 3²
    (the bicubic position embedding, shrinking and growing)."""
    _, cfg, params, tparams = dino_pair
    rs = np.random.RandomState(hw[0])
    img = rs.rand(2, *hw, 3).astype(np.float32)
    jnet, tnet = jdv.DinoViT(**cfg), tdv.DinoViT(**cfg)
    from deep3dmap_tpu_torch.utils.from_flax import load_flax_params
    load_flax_params(tnet, tparams)
    want_f, want_c = jnet.apply(params, jnp.asarray(img), layer=1, facet=facet)
    with torch.no_grad():
        got_f, got_c = tnet(torch.from_numpy(img), layer=1, facet=facet)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=2e-5)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=2e-5)


def test_dino_extractor_through_the_cli(dino_pair, tmp_path):
    """``tools/import_weights.py dino`` on a ``.pth`` writes JAX's file; both
    extractors read it (ImageNet normalisation, the crop to whole patches)."""
    sd = dino_pair[0]
    src, dst = str(tmp_path / "dino.pth"), str(tmp_path / "dino.npz")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, src)
    out = import_cli.main(["dino", src, dst])
    assert set(out) == {"params", "meta"}
    with np.load(dst, allow_pickle=True) as data:
        assert_trees_equal(data["params"].item(),
                           jax.tree_util.tree_map(np.asarray, dino_pair[2]))
        assert data["meta"].item() == dino_pair[1]
    img = np.random.RandomState(3).rand(2, 35, 33, 3).astype(np.float32)
    j = jdv.DinoExtractor.from_npz(dst, layer=2)
    m = tdv.DinoExtractor.from_npz(dst, layer=2, device="cpu")
    assert m.pretrained and m.embed_dim == 384
    np.testing.assert_allclose(m.extract(img).numpy(), j.extract(img), atol=2e-5)
