"""Port parity: ``models/modulars/stylegan2.py`` against the JAX package.

The JAX modules' ``init`` trees carried across by ``from_flax`` (raw leaves
declared in ``FLAX_LEAVES``); the same seeded inputs through both.  Covered:
the mapping net full and partial, ``ModulatedConv`` plain / up / down at
B = 1 and 3 with and without demodulation, the ``Generator`` from z, w and
w+ with explicit noise and nonzero ``noise_strength``, ``StyleDiscriminator``
scores and features at B = 1, 2 and 4, and the VJPs of the generator and
discriminator (inputs and every leaf) against ``jax.vjp``.

Tolerances, measured and rounded up: outputs within 2e-5 abs of values
O(1) (float32 sums of up to 4608 terms in another order); the generator's
and discriminator's input cotangents within 1e-5 of their largest value
(they reach O(10): 3.4e-5 abs measured), leaf cotangents within 1e-4 of
their leaf's largest value.

At B > 1 JAX's grouped convolution mixes the batch's pixels (the TRAP in
the port's module docstring); ``test_modulated_conv_batch_fold_is_jax``
pins that the port does the same, and that it is not the per-sample
convolution.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deep3dmap_tpu.models.modulars import stylegan2 as J
from deep3dmap_tpu_torch.models.modulars import stylegan2 as T
from deep3dmap_tpu_torch.utils.from_flax import (load_flax_params, to_flax_grads,
                                                 to_flax_params)

torch.set_num_threads(2)
ATOL = 2e-5
LEAF_RTOL = 1e-4
INPUT_RTOL = 1e-5
D = 32          # style_dim


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _close(j, t, atol=ATOL, msg=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=0, err_msg=msg)


def _scaled_close(j, t, rtol=INPUT_RTOL):
    j = np.asarray(j)
    _close(j, t, atol=rtol * max(float(np.abs(j).max()), 1.0))


def _leaves_close(want, got, prefix=""):
    for k, w in want.items():
        path = f"{prefix}/{k}"
        if isinstance(w, dict):
            _leaves_close(w, got[k], path)
            continue
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(got[k], w, atol=LEAF_RTOL * scale, rtol=0,
                                   err_msg=path)


def _randomise(tree, rng, names=("bias", "noise_strength", "b1", "b2", "frgb_b",
                                 "fc_b")):
    """Nonzero values for the leaves StyleGAN2 initialises to zero."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomise(v, rng, names)
        elif k in names:
            out[k] = np.asarray(0.3 * rng.randn(*np.shape(v)), np.float32)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def test_mapping_net_full_and_partial(rng):
    jm = J.MappingNet(style_dim=D, n_mlp=4)
    z = rng.randn(3, D).astype(np.float32)
    p = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(z)))
    p = {"params": _randomise(p["params"], rng)}
    tm = load_flax_params(T.MappingNet(D, 4), p)
    for kw in (dict(), dict(depth=2), dict(skip=2), dict(depth=3, skip=1),
               dict(depth=0)):
        _close(jm.apply(p, jnp.asarray(z), **kw), tm(_t(z), **kw), msg=str(kw))
    assert T.pixel_norm(_t(z)).shape == (3, D)


@pytest.mark.parametrize("demod", [True, False], ids=["demod", "nodemod"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("form", ["plain", "up", "down"])
def test_modulated_conv_matches_jax(rng, form, B, demod):
    kw = dict(up=form == "up", down=form == "down")
    jm = J.ModulatedConv(5, 3, demodulate=demod, **kw)
    x = rng.randn(B, 8, 8, 4).astype(np.float32)
    s = rng.randn(B, 6).astype(np.float32)
    p = _np(jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(s)))
    p = {"params": _randomise(p["params"], rng)}
    tm = load_flax_params(T.ModulatedConv(4, 5, 6, 3, demodulate=demod, **kw), p)
    want = {"plain": 8, "up": 16, "down": 4}[form]
    jy, jvjp = jax.vjp(lambda a, b: jm.apply(p, a, b), jnp.asarray(x), jnp.asarray(s))
    tx, ts = _t(x).requires_grad_(), _t(s).requires_grad_()
    ty = tm(tx, ts)
    assert tuple(ty.shape) == (B, want, want, 5) == jy.shape
    _close(jy, ty)
    g = rng.randn(*jy.shape).astype(np.float32)
    for a, b in zip(jvjp(jnp.asarray(g)), torch.autograd.grad(ty, (tx, ts), _t(g))):
        _close(a, b)


def test_modulated_conv_batch_fold_is_jax(rng):
    """At B = 3 both sides give JAX's batch-mixing numbers, which differ
    from running each sample alone by O(1)."""
    jm = J.ModulatedConv(5, 3)
    x = rng.randn(3, 8, 8, 4).astype(np.float32)
    s = rng.randn(3, 6).astype(np.float32)
    p = _np(jm.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(s)))
    tm = load_flax_params(T.ModulatedConv(4, 5, 6), p)
    together = tm(_t(x), _t(s)).detach().numpy()
    alone = np.concatenate([tm(_t(x[i:i + 1]), _t(s[i:i + 1])).detach().numpy()
                            for i in range(3)])
    _close(jm.apply(p, jnp.asarray(x), jnp.asarray(s)), torch.from_numpy(together))
    assert np.abs(together - alone).max() > 0.1


@pytest.fixture(scope="module")
def gen16():
    rs = np.random.RandomState(5)
    jg = J.Generator(size=16, style_dim=D, n_mlp=2, channel_multiplier=1)
    z = jnp.zeros((2, D))
    p = _np(jax.jit(lambda k: jg.init({"params": k, "noise": k}, z))(
        jax.random.PRNGKey(0)))
    p = {"params": _randomise(p["params"], rs)}
    tg = load_flax_params(T.Generator(16, D, 2, 1, device="cpu"), p)
    noise = [rs.randn(2, r, r, 1).astype(np.float32) for r in (4, 8, 8, 16, 16)]
    return jg, tg, p, noise, rs


@pytest.mark.parametrize("kind", ["z", "w", "wplus", "truncated"])
def test_generator_matches_jax(gen16, kind):
    jg, tg, p, noise, rs = gen16
    rng = np.random.RandomState(11)
    kw = {}
    if kind == "wplus":
        styles = rng.randn(2, jg.n_latent, D).astype(np.float32)
    else:
        styles = rng.randn(2, D).astype(np.float32)
    if kind != "z":
        kw["input_is_latent"] = True
    targs = dict(kw)
    if kind == "truncated":
        tl = rng.randn(1, D).astype(np.float32)
        kw.update(truncation=0.7, truncation_latent=jnp.asarray(tl))
        targs.update(truncation=0.7, truncation_latent=_t(tl))
    jy = jg.apply(p, jnp.asarray(styles), noise=[jnp.asarray(n) for n in noise], **kw)
    ty = tg(_t(styles), noise=[_t(n) for n in noise], **targs)
    assert tuple(ty.shape) == (2, 16, 16, 3)
    _close(jy, ty)
    assert tg.n_latent == jg.n_latent == 6


def test_generator_noise_draws(gen16):
    """``make_noise`` gives JAX's resolutions, from the caller's generator:
    the same seed gives the same image, another seed another one (the
    ``noise_strength`` leaves are nonzero)."""
    _, tg, _, noise, _ = gen16
    shapes = [tuple(n.shape) for n in tg.make_noise(2, torch.Generator().manual_seed(0))]
    assert shapes == [n.shape for n in noise]
    w = torch.zeros(2, D)
    a = tg(w, input_is_latent=True, rng=torch.Generator().manual_seed(3))
    b = tg(w, input_is_latent=True, rng=torch.Generator().manual_seed(3))
    c = tg(w, input_is_latent=True, rng=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.allclose(a, c)


def test_generator_vjp_matches_jax(gen16):
    jg, tg, p, noise, rs = gen16
    rng = np.random.RandomState(12)
    w = rng.randn(2, D).astype(np.float32)
    jn = [jnp.asarray(n) for n in noise]

    def jf(params, lat):
        return jg.apply(params, lat, input_is_latent=True, noise=jn)
    jy, jvjp = jax.vjp(jf, jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(w))
    tw = _t(w).requires_grad_()
    tg.zero_grad(set_to_none=True)
    ty = tg(tw, input_is_latent=True, noise=[_t(n) for n in noise])
    _close(jy, ty)
    g = rng.randn(*jy.shape).astype(np.float32)
    jgp, jgw = jvjp(jnp.asarray(g))
    ty.backward(_t(g))
    _scaled_close(jgw, tw.grad)
    _leaves_close(_np(jgp)["params"], to_flax_grads(tg))


@pytest.fixture(scope="module")
def disc16():
    rs = np.random.RandomState(6)
    jd = J.StyleDiscriminator(size=16, channel_multiplier=1)
    p = _np(jax.jit(lambda k: jd.init(k, jnp.zeros((1, 16, 16, 3))))(
        jax.random.PRNGKey(3)))
    p = {"params": _randomise(p["params"], rs)}
    return jd, load_flax_params(T.StyleDiscriminator(16, 1, device="cpu"), p), p


@pytest.mark.parametrize("B", [1, 2, 4])
def test_discriminator_matches_jax(disc16, B):
    jd, td, p = disc16
    x = np.random.RandomState(B).uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
    jout, jfeats = jd.apply(p, jnp.asarray(x), return_features=True)
    tout, tfeats = td(_t(x), return_features=True)
    assert tuple(tout.shape) == (B, 1)
    _close(jout, tout)
    assert len(tfeats) == len(jfeats) == 2
    for a, b in zip(jfeats, tfeats):
        assert tuple(b.shape) == a.shape
        _close(a, b)
    for n in (1, 2):
        assert [tuple(f.shape) for f in td.features(_t(x), n)] == \
            [f.shape for f in jfeats[:n]]


def test_discriminator_vjp_matches_jax(disc16):
    jd, td, p = disc16
    rng = np.random.RandomState(13)
    x = rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    jy, jvjp = jax.vjp(lambda q, a: jd.apply(q, a),
                       jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    tx = _t(x).requires_grad_()
    td.zero_grad(set_to_none=True)
    ty = td(tx)
    _close(jy, ty)
    g = rng.randn(*jy.shape).astype(np.float32)
    jgp, jgx = jvjp(jnp.asarray(g))
    ty.backward(_t(g))
    _scaled_close(jgx, tx.grad)
    _leaves_close(_np(jgp)["params"], to_flax_grads(td))


def test_raw_leaves_round_trip_and_raise(disc16, gen16):
    """``to_flax_params`` gives the flax trees back leaf for leaf; a missing
    leaf and an undeclared torch parameter raise."""
    for tm, p in ((disc16[1], disc16[2]), (gen16[1], gen16[2])):
        back = dict(jax.tree_util.tree_leaves_with_path(to_flax_params(tm)))
        want = dict(jax.tree_util.tree_leaves_with_path(p["params"]))
        assert back.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(back[k], want[k])
    tree = to_flax_params(disc16[1])
    del tree["block_16"]["b1"]
    with pytest.raises(ValueError, match="no flax leaf"):
        load_flax_params(T.StyleDiscriminator(16, 1, device="cpu"), tree)
    m = T.StyledConv(4, 4, 6)
    m.extra = torch.nn.Parameter(torch.zeros(1))
    with pytest.raises(ValueError, match="outside a flax-mirroring layer"):
        to_flax_params(m)


@torch.no_grad()
def test_init_stylegan2_distributions():
    g = T.Generator(16, D, 2, 1, device="cpu")
    T.init_stylegan2(g, torch.Generator().manual_seed(0))
    assert abs(float(g.conv_16.conv.weight.std()) - 1.0) < 0.02
    assert abs(float(g.mapping.dense_0.weight.std()) - 100.0) < 5.0   # 1 / lr_mlp
    assert abs(float(g.input_const.std()) - 1.0) < 0.05
    assert float(g.conv_16.bias.abs().max()) == 0.0
    assert float(g.conv_16.noise_strength) == 0.0
    d = T.StyleDiscriminator(16, 1, device="cpu")
    T.init_stylegan2(d, torch.Generator().manual_seed(0))
    assert abs(float(d.block_16.conv1_weight.std()) - 1.0) < 0.02
    assert abs(float(d.final_dense.weight.std()) - 1.0) < 0.02
    assert float(d.fc_b.abs().max()) == 0.0
    again = T.StyleDiscriminator(16, 1, device="cpu")
    T.init_stylegan2(again, torch.Generator().manual_seed(0))
    for a, b in zip(d.parameters(), again.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("ftr_num", [1, 2, 4])
def test_discriminator_loss_matches_jax(disc16, ftr_num):
    """``DiscriminatorLoss`` over the discriminator's features, masked, at
    B = 4: the value and its VJP to the prediction; the target gets none
    (4 > the two blocks of a 16² discriminator: both are used)."""
    from deep3dmap_tpu.models.losses.perceptual_loss import DiscriminatorLoss as JLoss
    from deep3dmap_tpu_torch.models.losses.perceptual_loss import DiscriminatorLoss

    jd, td, p = disc16
    rs = np.random.RandomState(14)
    pred, target = (rs.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32) for _ in range(2))
    mask = (rs.rand(4, 16, 16, 1) > 0.3).astype(np.float32)

    def jfeats(x):
        return jd.apply(p, x, return_features=True)[1]
    jl, jvjp = jax.vjp(lambda a: JLoss(ftr_num)(jfeats, a, jnp.asarray(target),
                                                mask=jnp.asarray(mask)), jnp.asarray(pred))
    tp, tt = _t(pred).requires_grad_(), _t(target).requires_grad_()
    tl = DiscriminatorLoss(ftr_num)(lambda x: td.features(x, ftr_num), tp, tt,
                                    mask=_t(mask))
    _close(jl, tl)
    tl.backward()
    _scaled_close(jvjp(jnp.ones_like(jl))[0], tp.grad)
    assert tt.grad is None
