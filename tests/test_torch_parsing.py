"""Gan2Shape's parsing models: the port against the JAX package on the CPU.

- ``Conv`` with ``dilation`` against flax's ``kernel_dilation`` (``SAME``
  padding of the dilated kernel, stride 1 and 2): 1e-5 abs.
- ``ops/resize.py`` against ``jax.image.resize``: bilinear shrink (JAX
  antialiases), grow and rectangular within 1e-6 abs; nearest exact.
- ``BiSeNetFP``, the compact ``BiSeNet`` and ``PSPNet`` (21 and 150 classes)
  against their flax twins on logits, the JAX init carried across by
  ``utils/from_flax.py``: 2e-5 abs on logits of magnitude ~1-4 (measured
  up to 4.4e-6; float32 convs summed in another order).
- ``FaceParser``/``SceneParser.parse_mask`` for every category against
  JAX's, each side loading the same ``.npz`` (a ``params`` tree as
  ``tools/import_weights.py`` writes it) from a JAX ``init`` and, for the
  face parser, from ``import_bisenet`` on ``tests/test_bisenet_fp.py``'s
  synthetic checkpoint.  Logits at the parsers' 512² / 473² inputs agree
  to 1e-3 abs or 2e-5 of their largest magnitude, whichever is larger:
  PSPNet's GroupNorms use flax's variance E[x²] - E[x]², whose cancellation
  on the smooth upsampled faces turns the two sides' summation orders into
  up to 3.3e-4 (measured); the synthetic checkpoint's unnormalised
  BN-folded trunk drives the logits to 6.3e5 (measured difference 3.2).
  The mask is an argmax, so the class maps must agree on every pixel whose
  top-2 margin in JAX's logits exceeds 1e-3, or twice 2e-5 of the largest
  logit where that is more (the near-tie rule); on the pixels below it
  (0.04-0.48% of the map) they may differ, in at most 0.1% of the map
  (measured: none for the face parser from a JAX init, 3.8e-6 of the map
  from the imported checkpoint, 5.8e-5 to 2.6e-4 for PSPNet).  Where the
  class maps agree the masks agree to 1e-6 after the resize to
  ``out_size``; either way JAX's mask is the category rule and the resize
  applied to its own class map.
"""
import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch

from deep3dmap_tpu.datasets.gan_faces import SyntheticGanFaceDataset
from deep3dmap_tpu.models.parsing import bisenet_fp as JFP
from deep3dmap_tpu.models.parsing import pspnet as JPSP
from deep3dmap_tpu.models.parsing.bisenet import BiSeNet as JBiSeNet
from deep3dmap_tpu.utils.torch_import import import_bisenet
from deep3dmap_tpu_torch.models.layers import Conv
from deep3dmap_tpu_torch.models.parsing import (BiSeNet, BiSeNetFP, FaceParser, PSPNet,
                                                SceneParser)
from deep3dmap_tpu_torch.models.parsing.bisenet_fp import category_mask
from deep3dmap_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from deep3dmap_tpu_torch.utils.from_flax import load_flax_params
from test_bisenet_fp import make_faceparsing_sd

torch.set_num_threads(2)
LOGIT_ATOL = 2e-5       # the nets at 64-96 px
PARSE_ATOL = 1e-3       # the parsers' logits at 512² / 473²
REL_OF_MAX = 2e-5       # ... or this share of their largest magnitude
MARGIN = 1e-3           # the near-tie rule
MAX_TIE_SHARE = 1e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


@pytest.mark.parametrize("k,d,s,size", [(3, 2, 1, 9), (3, 4, 1, 16), (3, 2, 2, 10),
                                        (5, 3, 1, 7), (3, 2, 2, 11)])
def test_conv_dilation_matches_flax(rng, k, d, s, size):
    x = rng.randn(2, size, size + 3, 4).astype(np.float32)
    conv = fnn.Conv(6, (k, k), strides=(s, s), kernel_dilation=(d, d))
    p = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(p, jnp.asarray(x)))
    tconv = load_flax_params(Conv(4, 6, (k, k), s, dilation=d), _np_tree(p))
    got = tconv(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw,out", [((64, 64), (16, 16)), ((16, 16), (64, 64)),
                                    ((37, 64), (128, 20)), ((12, 30), (12, 47)),
                                    ((512, 512), (128, 128))],
                         ids=["shrink", "grow", "rect", "one_axis", "mask_512_128"])
@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_resize_matches_jax(rng, hw, out, method):
    x = rng.randn(2, *hw, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *out, 3), method))
    fn = resize_bilinear if method == "bilinear" else resize_nearest
    got = fn(torch.from_numpy(x), out).numpy()
    assert got.shape == want.shape
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_nearest_is_not_torch_nearest():
    """JAX's nearest samples at half-pixel centres: torch's ``nearest-exact``
    at a 3:5 factor, where torch's ``nearest`` picks other rows."""
    x = torch.arange(5.0).reshape(1, 5, 1, 1)
    got = resize_nearest(x, (3, 1))[0, :, 0, 0]
    want = np.asarray(jax.image.resize(jnp.arange(5.0).reshape(1, 5, 1, 1),
                                       (1, 3, 1, 1), "nearest"))[0, :, 0, 0]
    np.testing.assert_array_equal(got.numpy(), want)
    exact = torch.nn.functional.interpolate(x.movedim(-1, 1), size=(3, 1),
                                            mode="nearest-exact")[0, 0, :, 0]
    plain = torch.nn.functional.interpolate(x.movedim(-1, 1), size=(3, 1),
                                            mode="nearest")[0, 0, :, 0]
    np.testing.assert_array_equal(exact.numpy(), want)
    assert not np.array_equal(plain.numpy(), want)


@pytest.mark.parametrize("name", ["bisenet_fp", "bisenet", "pspnet21", "pspnet150"])
def test_parsing_logits_match_flax(rng, name):
    jnet, tnet, hw = {
        "bisenet_fp": (JFP.BiSeNetFP(), BiSeNetFP(), (64, 96)),
        "bisenet": (JBiSeNet(), BiSeNet(), (64, 48)),
        "pspnet21": (JPSP.PSPNet(), PSPNet(), (57, 64)),
        "pspnet150": (JPSP.PSPNet(n_classes=150), PSPNet(150), (64, 64)),
    }[name]
    x = rng.uniform(-1, 1, (2, *hw, 3)).astype(np.float32)
    p = jax.jit(jnet.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jax.jit(jnet.apply)(p, jnp.asarray(x)))
    load_flax_params(tnet, _np_tree(p))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *hw, want.shape[-1])
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


# -- parse_mask ---------------------------------------------------------------
def _faces(n, size=64):
    ds = SyntheticGanFaceDataset(n_samples=n, image_size=size, z_dim=8)
    return np.concatenate([ds.setup_input(i)["input_im"] for i in range(n)])


def _write_npz(path, params):
    np.savez(path, params=np.array(_np_tree(params), dtype=object))
    return str(path)


@pytest.fixture(scope="module")
def npz_files(tmp_path_factory):
    """``.npz`` files from JAX inits (the face parser, PSPNet with 21 and
    150 classes) and from ``import_bisenet`` on a synthetic face-parsing
    state dict."""
    root = tmp_path_factory.mktemp("parsing")
    x = jnp.zeros((1, 64, 64, 3))
    out = {}
    for key, net, seed in (("bisenet", JFP.BiSeNetFP(), 3), ("psp21", JPSP.PSPNet(), 4),
                           ("psp150", JPSP.PSPNet(n_classes=150), 5)):
        out[key] = _write_npz(root / f"{key}.npz",
                              jax.jit(net.init)(jax.random.PRNGKey(seed), x))
    sd = make_faceparsing_sd(np.random.RandomState(7))
    out["imported"] = _write_npz(root / "imported.npz", import_bisenet(sd))
    return out


def _check_masks(jparser, tparser, images, category, out_size):
    """The class maps under the near-tie rule, then the masks."""
    size = 512 if category in ("face", "synface") else 473
    x = jax.image.resize(jnp.asarray(images), (images.shape[0], size, size, 3), "bilinear")
    if category in ("car", "cat"):
        x = (x / 2 + 0.5 - JFP._IMAGENET_MEAN) / JFP._IMAGENET_STD
    jlogits = np.asarray(jparser._apply(jparser.params, x))
    with torch.no_grad():
        tlogits = tparser.net(torch.from_numpy(np.asarray(x))).numpy()
    scaled = REL_OF_MAX * float(np.abs(jlogits).max())
    np.testing.assert_allclose(tlogits, jlogits, atol=max(PARSE_ATOL, scaled), rtol=0)
    top2 = np.sort(jlogits, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > max(MARGIN, 2 * scaled)
    jcls, tcls = jlogits.argmax(-1), tlogits.argmax(-1)
    assert np.array_equal(jcls[sure], tcls[sure]), category
    assert (jcls != tcls).mean() <= MAX_TIE_SHARE
    assert len(np.unique(jcls)) > 1, "a one-class map tests no category rule"

    jmask = np.asarray(jparser.parse_mask(jnp.asarray(images), category, out_size=out_size))
    tmask = tparser.parse_mask(torch.from_numpy(images), category, out_size=out_size)
    assert tmask.shape == jmask.shape == (images.shape[0], out_size, out_size, 1)
    if np.array_equal(jcls, tcls):
        np.testing.assert_allclose(tmask.numpy(), jmask, atol=1e-6, rtol=0)
    # the category rule and the resize on JAX's own class map
    ref = resize_bilinear(category_mask(torch.from_numpy(jcls), category)[..., None], out_size)
    np.testing.assert_allclose(ref.numpy(), jmask, atol=1e-6, rtol=0)


@pytest.mark.parametrize("weights", ["bisenet", "imported"])
def test_face_parser_masks_match_jax(npz_files, weights):
    images = _faces(2)
    jparser = JFP.FaceParser(npz_files[weights])
    tparser = FaceParser(npz_files[weights], device="cpu")
    for category in ("face", "synface"):
        _check_masks(jparser, tparser, images, category, out_size=64)


@pytest.mark.parametrize("n_classes,categories", [(21, ("car", "cat", "horse")),
                                                  (150, ("church",))])
def test_scene_parser_masks_match_jax(npz_files, n_classes, categories):
    path = npz_files["psp21" if n_classes == 21 else "psp150"]
    images = _faces(1)
    jparser = JPSP.SceneParser(path, n_classes=n_classes)
    tparser = SceneParser(path, n_classes=n_classes, device="cpu")
    for category in categories:
        _check_masks(jparser, tparser, images, category, out_size=32)


def test_category_rules_match_jax():
    """Every class id through ``category_mask``: JAX's rules
    (``bisenet_fp.py:175-185``), including the face mask's 0 / 0.5 / 1."""
    parser = JFP.FaceParser.__new__(JFP.FaceParser)
    parser.params = None
    cls = np.arange(150, dtype=np.int32).reshape(1, 10, 15)
    for category in ("face", "synface", "car", "cat", "church", "horse"):
        n = 19 if category in ("face", "synface") else 150
        c = np.minimum(cls, n - 1)
        lg = jax.nn.one_hot(c, n) * 10.0
        parser._apply = lambda p, x, lg=lg: jax.image.resize(
            lg, (1, x.shape[1], x.shape[2], n), "nearest")
        # the class map nearest-resized to the parser's size and back
        want = np.asarray(parser.parse_mask(jnp.zeros((1, 8, 8, 3)), category))
        want = np.asarray(jax.image.resize(jnp.asarray(want), (1, 10, 15, 1), "nearest"))
        got = category_mask(torch.from_numpy(c), category)[..., None].numpy()
        np.testing.assert_array_equal(got, want, err_msg=category)
