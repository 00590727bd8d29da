"""Port parity: Gan2Shape's step-1 slice against the JAX package.

Layers (``ConvTranspose``, ``Encoder``, ``EDDeconv``, the VGG trunk and
``PerceptualLoss``) against flax within 1e-5 abs with the weights carried by
``from_flax``; then the whole slice (``forward_step1``, ``forward_test``) at
``tests/test_gan2shape.py``'s config (32², ``nf=8``) in both raster modes,
with and without an ``input_mask``, the JAX ``Gan2Shape.init`` params and
``PerceptualLoss.params`` carried across.  Slice tolerances: losses within
1e-4 rel; depth and albedo within 1e-5 abs; normal within 1e-5 abs of the
JAX normal of the port's depth, and within 4e-5 end to end (it divides
depth differences by the pixel spacing, so a last-ulp depth difference
grows 90x); recon_depth and recon_im within 1e-4 abs with identical coverage
(recon_depth != max_depth).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch

from deep3dmap_tpu.datasets.gan_faces import SyntheticGanFaceDataset as JDataset
from deep3dmap_tpu.models.backbones.encoder import Encoder as JEncoder
from deep3dmap_tpu.models.backbones.encoder_decoder import EDDeconv as JEDDeconv
from deep3dmap_tpu.models.frameworks import gan2shape as JG
from deep3dmap_tpu.models.losses.perceptual_loss import PerceptualLoss as JPerceptual
from deep3dmap_tpu_torch.datasets.gan_faces import SyntheticGanFaceDataset
from deep3dmap_tpu_torch.models.backbones.encoder import Encoder
from deep3dmap_tpu_torch.models.backbones.encoder_decoder import EDDeconv
from deep3dmap_tpu_torch.models.frameworks import gan2shape as TG
from deep3dmap_tpu_torch.models.layers import ConvTranspose
from deep3dmap_tpu_torch.models.losses.perceptual_loss import PerceptualLoss
from deep3dmap_tpu_torch.utils.from_flax import load_flax_params, to_flax_params

torch.set_num_threads(2)
CFG = dict(image_size=32, gan_size=32, z_dim=32, n_mlp=4, nf=8, batchsize=2,
           channel_multiplier=1)
ATOL = 1e-5
NORMAL_ATOL = 4e-5   # three ulps of depth, amplified (see the slice test)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("hw,kernel", [(1, (4, 4)), (3, (4, 4)), (2, (3, 5))])
def test_conv_transpose_matches_flax(rng, hw, kernel):
    x = rng.randn(2, hw, hw, 5).astype(np.float32)
    jm = fnn.ConvTranspose(6, kernel, strides=(1, 1), padding="VALID")
    p = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    p["params"]["bias"] = rng.randn(6).astype(np.float32)
    tm = load_flax_params(ConvTranspose(5, 6, kernel), p)
    _close(jm.apply(p, jnp.asarray(x)), tm(_t(x)))
    if hw == 1:   # flax does not flip: out[i, j] = K[3-i, 3-j] . x
        k = p["params"]["kernel"]
        want = np.einsum("c,ijco->ijo", x[0, 0, 0], k[::-1, ::-1]) + p["params"]["bias"]
        np.testing.assert_allclose(tm(_t(x))[0].detach().numpy(), want, atol=ATOL)
    back = to_flax_params(tm)
    for k in ("kernel", "bias"):
        np.testing.assert_array_equal(back[k], p["params"][k])


def test_conv_transpose_missing_leaf_raises(rng):
    tm = ConvTranspose(5, 6, (4, 4))
    with pytest.raises(ValueError, match="no flax leaf"):
        load_flax_params(tm, {"kernel": np.zeros((4, 4, 5, 6), np.float32)})


@pytest.mark.parametrize("activation,cout", [("tanh", 6), ("none", 32)])
def test_encoder_matches_flax(rng, activation, cout):
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jm = JEncoder(cout=cout, nf=8, activation=activation)
    p = _np_tree(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    tm = load_flax_params(Encoder(cout=cout, nf=8, activation=activation), p)
    _close(jm.apply(p, jnp.asarray(x)), tm(_t(x)))


@pytest.mark.parametrize("size,cout", [(32, 1), (64, 3)])
def test_eddeconv_matches_flax(rng, size, cout):
    x = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    jm = JEDDeconv(cout=cout, nf=8)
    p = _np_tree(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    tm = EDDeconv(size, cout=cout, nf=8)
    load_flax_params(tm, p)
    _close(jm.apply(p, jnp.asarray(x)), tm(_t(x)))
    # the round trip gives the flax tree back leaf for leaf
    back = jax.tree_util.tree_leaves_with_path(to_flax_params(tm))
    want = dict(jax.tree_util.tree_leaves_with_path(p["params"]))
    assert len(back) == len(want)
    for path, leaf in back:
        np.testing.assert_array_equal(leaf, want[path])


def test_perceptual_loss_matches_jax(rng):
    jl = JPerceptual()
    tl = PerceptualLoss(seed=3, device="cpu")
    tl.load_flax(_np_tree(jl.params))
    a = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.3, a.shape), -1, 1).astype(np.float32)
    feats_j = jl.net.apply(jl.params, jnp.asarray(a))
    feats_t = tl.net(_t(a))
    assert len(feats_t) == 5
    for fj, ft in zip(feats_j, feats_t):
        _close(fj, ft)
    want = np.asarray(jl(jnp.asarray(a), jnp.asarray(b)))
    got = tl(_t(a), _t(b)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)


def test_dataset_copy_matches():
    a = JDataset(n_samples=2, image_size=32, z_dim=32).setup_input(1)
    b = SyntheticGanFaceDataset(n_samples=2, image_size=32, z_dim=32).setup_input(1)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_loss_utils_match_jax(rng):
    x = rng.randn(2, 8, 8, 3).astype(np.float32)
    y = rng.randn(2, 8, 8, 3).astype(np.float32)
    m = (rng.rand(2, 8, 8, 1) > 0.5).astype(np.float32)
    for args in ((x, y), (x, y, m)):
        np.testing.assert_allclose(
            float(TG.photometric_loss(*map(_t, args))),
            float(JG.photometric_loss(*map(jnp.asarray, args))), rtol=1e-6)
    for a in (x, x[..., 0]):
        np.testing.assert_allclose(float(TG.smooth_loss(_t(a))),
                                   float(JG.smooth_loss(jnp.asarray(a))), rtol=1e-6)


@pytest.fixture(scope="module")
def jax_weights():
    """The JAX framework's init (heads) and its perceptual weights."""
    fw = JG.Gan2Shape(CFG)
    batch = JDataset(n_samples=2, image_size=32, z_dim=32).setup_input(0)
    params, mstate = fw.init(jax.random.PRNGKey(0), batch)
    return _np_tree(params), mstate, _np_tree(fw.perceptual.params), batch


def _variant(mode, masked):
    cfg = dict(CFG, raster_mode=mode)
    if masked:
        cfg["use_mask"] = True
    return cfg


def _batch(base, masked):
    batch = dict(base)
    if masked:
        S = CFG["image_size"]
        yy, xx = np.meshgrid(np.linspace(-1, 1, S), np.linspace(-1, 1, S),
                             indexing="ij")
        batch["input_mask"] = ((xx ** 2 + yy ** 2) < 0.6).astype(
            np.float32)[None, ..., None]
    return batch


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("mode", ["splat", "hard"])
def test_step1_slice_matches_jax(jax_weights, mode, masked):
    params, mstate, perc, base = jax_weights
    cfg = _variant(mode, masked)
    batch = _batch(base, masked)
    jfw = JG.Gan2Shape(cfg)
    jfw.perceptual.params = jax.tree_util.tree_map(jnp.asarray, perc)
    jtotal, jlog, jout = jfw.forward_step1(params, mstate, batch, jax.random.PRNGKey(1))
    jtest, _ = jfw.forward_test(params, mstate, batch)

    tfw = TG.Gan2Shape(cfg, device="cpu")
    net = tfw.load_flax(params, perc)
    ttotal, tlog, tout = tfw.forward_step1(net, {}, batch)
    ttest, _ = tfw.forward_test(net, {}, batch)

    np.testing.assert_allclose(float(ttotal.detach()), float(jtotal), rtol=1e-4)
    for k in ("loss_l1", "loss_perc", "loss_smooth"):
        np.testing.assert_allclose(float(tlog[k].detach()), float(jlog[k]),
                                   rtol=1e-4, err_msg=k)
    assert set(ttest) == set(jtest) == {"depth", "albedo", "normal",
                                        "recon_im", "recon_depth"}
    for outs_t, outs_j in ((tout, jout), (ttest, jtest)):
        for k in ("depth", "albedo"):
            _close(outs_j[k], outs_t[k], atol=1e-5)
        # normals from the same depth agree within 1e-5; end to end they
        # carry the depth's last-ulp difference (1.2e-7) divided by the
        # pixel spacing 2/fx ~ 0.011 at 32 px: 1.1e-5 per ulp
        same_depth = jfw.renderer.get_normal_from_depth(
            jnp.asarray(outs_t["depth"].detach().numpy()))
        _close(same_depth, outs_t["normal"], atol=1e-5)
        _close(outs_j["normal"], outs_t["normal"], atol=NORMAL_ATOL)
        jd = np.asarray(outs_j["recon_depth"])
        td = outs_t["recon_depth"].detach().numpy()
        bg = np.float32(tfw.max_depth)
        np.testing.assert_array_equal(jd != bg, td != bg, err_msg="coverage")
        for k in ("recon_depth", "recon_im"):
            _close(outs_j[k], outs_t[k], atol=1e-4)
