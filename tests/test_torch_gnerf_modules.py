"""GNeRF's modules in the port against their JAX/flax twins, forward and
VJP, on the CPU in float32 (the same seeded inputs, flax's weights carried
across by ``from_flax``, the same random cotangents).

Tolerances (relative, by norm): 1e-6 for data movement and pose algebra
(``take_rows``, the samplers, ``get_rays``, DiffAugment), 1e-5 for sums of
a few hundred terms in another order (the layers, the discriminator, the
inversion net, the MLP).  The renderer's colours go through the positional
encoding's sin(2^9 x): XLA contracts ``o + d * z`` into a fused
multiply-add where torch rounds twice, and the ulp of x, times 512, reaches
the MLP's input; its forward is held to 1e-4 and its VJP to 1e-4, with the
importance samples shared (``SharedSamples``: ``sample_pdf`` is
discontinuous at its ``denom < eps`` branch and at u = 1, where another
summation order moves a sample by up to a bin; ``sample_pdf`` itself is
held alone, away from those points, to 1e-6).
"""
import importlib

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import torch

from deep3dmap_tpu.core.renderer import renderer_nfvr as JR
from deep3dmap_tpu.core.renderer.samples import patch_sampler as JP
from deep3dmap_tpu.core.renderer.samples import ray_sampler as JS
from deep3dmap_tpu.models.backbones.nerf import NeRF as JNeRF
from deep3dmap_tpu.models.modulars import embeddings as JE
from deep3dmap_tpu.models.modulars.dynamic_patch_discriminator import \
    Discriminator as JDisc
from deep3dmap_tpu.models.modulars.gnerf import GNeRFRender as JRender
from deep3dmap_tpu.models.modulars.inversion_net import InversionNet as JInv
from deep3dmap_tpu_torch.core.renderer import renderer_nfvr as TR
from deep3dmap_tpu_torch.core.renderer.samples import patch_sampler as TP
from deep3dmap_tpu_torch.core.renderer.samples import ray_sampler as TS
from deep3dmap_tpu_torch.models import layers as TL
from deep3dmap_tpu_torch.models.backbones.nerf import NeRF as TNeRF
from deep3dmap_tpu_torch.models.modulars import embeddings as TE
from deep3dmap_tpu_torch.models.modulars.dynamic_patch_discriminator import \
    Discriminator as TDisc
from deep3dmap_tpu_torch.models.modulars.gnerf import GNeRFRender as TRender
from deep3dmap_tpu_torch.models.modulars.inversion_net import InversionNet as TInv
from deep3dmap_tpu_torch.utils.from_flax import load_flax_params
from gnerf_helpers import SharedSamples, leaf_errors, np_tree, rel

# the packages export the function ``diff_augment``, which shadows its module
JA = importlib.import_module("deep3dmap_tpu.models.function_utils.diff_augment")
TA = importlib.import_module("deep3dmap_tpu_torch.models.function_utils.diff_augment")
torch.set_num_threads(2)
MOVE = 1e-6
SUM = 1e-5
ENC = 1e-4


def _t(a, grad=False):
    t = torch.tensor(np.asarray(a, np.float32))
    return t.requires_grad_(grad)


def _vjp(jf, tf, args, rng, grad_args=None):
    """Forward and input VJP of ``jf``/``tf`` on the same ``args`` under one
    random cotangent: (forward rel, [input-grad rel])."""
    grad_args = range(len(args)) if grad_args is None else grad_args
    jargs = [jnp.asarray(a) for a in args]
    out, pull = jax.vjp(jf, *jargs)
    cot = rng.randn(*out.shape).astype(np.float32)
    jg = pull(jnp.asarray(cot))
    targs = [_t(a, i in grad_args) for i, a in enumerate(args)]
    tout = tf(*targs)
    tg = torch.autograd.grad(tout, [targs[i] for i in grad_args], torch.from_numpy(cot),
                             allow_unused=True)
    tg = [torch.zeros_like(targs[i]) if g is None else g for i, g in zip(grad_args, tg)]
    return rel(out, tout.detach()), [rel(jg[i], g, 1e-6) for i, g in zip(grad_args, tg)]


# -- embeddings --------------------------------------------------------------------
@pytest.mark.parametrize("idx", [[0, 3, 1], [0, 3, 7], [-1, 2, 9, 0], [5, 5, 6]])
def test_take_rows_clamps_and_drops_like_jax(idx):
    """JAX's ``x[idx]``: an index past the end reads the last row, and its
    gradient is dropped, not added to that row."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 9).astype(np.float32)
    cot = rng.randn(len(idx), 9).astype(np.float32)
    want, pull = jax.vjp(lambda a: a[jnp.asarray(idx)], jnp.asarray(x))
    (jg,) = pull(jnp.asarray(cot))
    tx = _t(x, True)
    got = TE.take_rows(tx, torch.tensor(idx, dtype=torch.int32))
    (tg,) = torch.autograd.grad(got, tx, torch.from_numpy(cot))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)


def test_take_rows_one_row_gradient_is_not_summed():
    """The trap of the published configs: one val pose indexed with a
    batch's 0-7; ``grad((x[[0, 3, 7]] ** 2).sum())`` is 2x, not 6x."""
    x = np.array([[0.5, -1.0]], np.float32)
    jg = jax.grad(lambda a: (a[jnp.array([0, 3, 7])] ** 2).sum())(jnp.asarray(x))
    tx = _t(x, True)
    (TE.take_rows(tx, torch.tensor([0, 3, 7])) ** 2).sum().backward()
    np.testing.assert_allclose(np.asarray(jg), 2 * x)
    np.testing.assert_allclose(tx.grad.numpy(), 2 * x)


def test_embedding_and_rotation_helpers():
    rng = np.random.RandomState(1)
    x = rng.randn(5, 3).astype(np.float32)
    for n in (4, 10):
        f, g = _vjp(lambda a: JE.high_dim_embedding(a, n), lambda a: TE.high_dim_embedding(a, n),
                    [x], rng)
        assert f < MOVE and g[0] < MOVE
        assert TE.embedding_out_channels(3, n) == JE.embedding_out_channels(3, n)
    d6 = rng.randn(6, 6).astype(np.float32)
    f, g = _vjp(JE.r6d2mat, TE.r6d2mat, [d6], rng)
    assert f < MOVE and g[0] < MOVE
    pose = rng.randn(6, 3, 4).astype(np.float32)
    f, g = _vjp(JE.pose_to_d9, TE.pose_to_d9, [pose], rng)
    assert f == 0 and g[0] == 0


@pytest.mark.parametrize("mode", ["6d", "3d"])
def test_pose_parameters(mode):
    rng = np.random.RandomState(2)
    jm = JE.PoseParameters(4, mode)
    idx = jnp.array([3, 0, 5])
    params = jm.init(jax.random.PRNGKey(0), idx)
    params = {"params": {"poses_embed": params["params"]["poses_embed"]
                         + jnp.asarray(rng.randn(*params["params"]["poses_embed"].shape)
                                       .astype(np.float32) * 0.1)}}
    tm = TE.PoseParameters(4, mode)
    np.testing.assert_allclose(tm.initial_embed().numpy(),
                               np.asarray(jm.init(jax.random.PRNGKey(0), idx)["params"]
                                          ["poses_embed"]), atol=1e-7)
    load_flax_params(tm, np_tree(params))
    out, pull = jax.vjp(lambda p: jm.apply(p, idx), params)
    cot = rng.randn(*out.shape).astype(np.float32)
    (jg,) = pull(jnp.asarray(cot))
    got = tm(torch.tensor([3, 0, 5]))
    got.backward(torch.from_numpy(cot))
    assert rel(out, got.detach()) < MOVE
    assert max(leaf_errors(jg["params"], tm).values()) < MOVE
    assert rel(jm.apply(params), tm().detach()) < MOVE


# -- samplers --------------------------------------------------------------------------
def _sampler_pair(**kw):
    cfg = dict(near=0.5, far=4.0, azim_range=(0, 360), elev_range=(10, 50),
               radius=(1.0, 1.5), **kw)
    K = np.array([[40, 0, 15.5], [0, 38, 12], [0, 0, 1]], np.float32)
    js, ts = JS.RaySampler(**cfg), TS.RaySampler(**cfg, device="cpu")
    js.set_start_intrinsics(K)
    ts.set_start_intrinsics(K)
    return js, ts


def test_look_at_rotation_and_poses():
    rng = np.random.RandomState(3)
    pos = rng.randn(7, 3).astype(np.float32)
    f, g = _vjp(JS.look_at_rotation, TS.look_at_rotation, [pos], rng)
    assert f < MOVE and g[0] < MOVE
    # up parallel to z: the fallback x axis (JAX's gradient there is NaN,
    # 0/0 in the norm of x; the port's is finite)
    top = np.array([[0, 0, 2.0], [0, 0, -1.5]], np.float32)
    np.testing.assert_array_equal(np.asarray(JS.look_at_rotation(jnp.asarray(top))),
                                  TS.look_at_rotation(_t(top)).numpy())
    js, ts = _sampler_pair()
    key = jax.random.PRNGKey(4)
    raes = np.asarray(jax.random.uniform(jax.random.split(key)[0], (5, 3)))
    assert rel(js.random_poses(key, 5), ts.random_poses({"raes": _t(raes)})) < MOVE
    assert rel(js.spheric_poses(9), ts.spheric_poses(9)) < MOVE
    assert ts.pose_draws(torch.Generator().manual_seed(0), 5)["raes"].shape == (5, 3)
    js.update_intrinsic(0.5)
    ts.update_intrinsic(0.5)
    np.testing.assert_array_equal(np.asarray(js.intrinsics), ts.intrinsics.numpy())
    np.testing.assert_array_equal(np.asarray(js.start_intrinsics), ts.start_intrinsics.numpy())


@pytest.mark.parametrize("full", [False, True])
def test_get_rays(full):
    rng = np.random.RandomState(5)
    js, ts = _sampler_pair()
    if full:
        coords = np.asarray(JP.FullImageSampler()(None, 2, (12, 9))[0])
        assert rel(coords, TP.FullImageSampler()(2, (12, 9))[0]) < MOVE
    else:
        coords = rng.uniform(-1, 1, (2, 6, 6, 2)).astype(np.float32)
    poses = np.asarray(js.random_poses(jax.random.PRNGKey(1), 2))
    f, g = _vjp(lambda c, p: js.get_rays(c, p, (12, 9)), lambda c, p: ts.get_rays(c, p, (12, 9)),
                [coords, poses], rng)
    assert f < MOVE and max(g) < MOVE


@pytest.mark.parametrize("it", [0, 3000, 20000])
def test_patch_samplers(it):
    key = jax.random.PRNGKey(6)
    kw = dict(min_scale=0.25, max_scale=1.0, scale_anneal=0.0002)
    jf, tf = JP.FlexPatchSampler(**kw), TP.FlexPatchSampler(**kw)
    r1, r2, r3 = jax.random.split(key, 3)
    draws = {k: _t(jax.random.uniform(r, (3, 1, 1, 1)))
             for k, r in zip(("scale", "h_off", "w_off"), (r1, r2, r3))}
    jc, js_ = jf(key, 3, 8, jnp.int32(it))
    tc, ts_ = tf(draws, 3, 8, torch.tensor(it, dtype=torch.int32))
    assert rel(jc, tc) < MOVE and rel(js_, ts_) < MOVE
    jc, _ = JP.RescalePatchSampler(0.5)(None, 3, 8)
    assert rel(jc, TP.RescalePatchSampler(0.5)(3, 8)[0]) < MOVE


def test_sample_image_patches_vjp():
    rng = np.random.RandomState(7)
    imgs = rng.randn(2, 10, 12, 3).astype(np.float32)
    coords = rng.uniform(-1.1, 1.1, (2, 5, 5, 2)).astype(np.float32)
    f, g = _vjp(JP.sample_image_patches, TP.sample_image_patches, [imgs, coords], rng,
                grad_args=[0])
    assert f < MOVE and g[0] < MOVE


# -- volume rendering ----------------------------------------------------------------
@pytest.mark.parametrize("det", [False, True])
def test_sample_pdf(det):
    rng = np.random.RandomState(8)
    bins = np.sort(rng.rand(16, 9).astype(np.float32), -1)
    w = rng.rand(16, 8).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = JR.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), 6, det=det)
    u = (np.asarray(jnp.broadcast_to(jnp.linspace(0, 1, 6), (16, 6))) if det
         else np.asarray(jax.random.uniform(key, (16, 6))))
    got = TR.sample_pdf(_t(bins), _t(w), _t(u))
    # away from the top edge, where u = 1 meets a cdf that sums to 1 +- ulp
    keep = u < 1
    assert rel(np.asarray(want)[keep], got.numpy()[keep]) < MOVE


@pytest.mark.parametrize("white_back", [False, True])
def test_volume_render_vjp(white_back):
    rng = np.random.RandomState(10)
    N, S = 12, 9
    sig = (rng.randn(N, S) * 3).astype(np.float32)
    rgbs = rng.rand(N, S, 3).astype(np.float32)
    z = np.sort(rng.rand(N, S).astype(np.float32) * 3 + 0.5, -1)
    d = rng.randn(N, 3).astype(np.float32)
    far = np.full((N, 1), 4.0, np.float32)
    for k in range(3):
        f, g = _vjp(lambda *a: JR.volume_render(*a, white_back=white_back)[k],
                    lambda *a: TR.volume_render(*a, white_back=white_back)[k],
                    [sig, rgbs, z, d, far], rng, grad_args=[0, 1, 3])
        assert f < MOVE and max(g) < 1e-5, (k, f, g)


# -- the MLP and the renderer -------------------------------------------------------
def test_nerf_mlp_vjp():
    rng = np.random.RandomState(11)
    xyz = rng.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    d = rng.randn(64, 3).astype(np.float32)
    jm, tm = JNeRF(fc_depth=6, fc_dim=32), TNeRF(fc_depth=6, fc_dim=32)
    params = jm.init(jax.random.PRNGKey(0), xyz, d)
    load_flax_params(tm, np_tree(params))
    out, pull = jax.vjp(lambda p, a, b: jm.apply(p, a, b), params, jnp.asarray(xyz), jnp.asarray(d))
    cot = rng.randn(*out.shape).astype(np.float32)
    jp, jx, _ = pull(jnp.asarray(cot))
    tx = _t(xyz, True)
    got = tm(tx, _t(d))
    got.backward(torch.from_numpy(cot))
    assert rel(out, got.detach()) < SUM and rel(jx, tx.grad) < SUM
    assert max(leaf_errors(jp["params"], tm).values()) < SUM
    assert rel(jm.apply(params, xyz, sigma_only=True), tm(_t(xyz), sigma_only=True).detach()) < SUM


@pytest.mark.parametrize("stochastic", [True, False])
def test_gnerf_render_vjp(stochastic, monkeypatch):
    """Coarse then fine, against ``GNeRFRender.apply`` with JAX's draws and
    the port's importance samples; the VJP reaches the rays (pose
    refinement) and every weight."""
    rng = np.random.RandomState(12)
    N = 48
    o = rng.randn(N, 3).astype(np.float32) * 0.2 + np.array([0, 0, 2.5], np.float32)
    d = rng.randn(N, 3).astype(np.float32) * 0.2 + np.array([0, 0, -1], np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((N, 1), 0.5), np.full((N, 1), 4.0)], -1)
    cfg = dict(fc_depth=3, fc_dim=32, n_samples=8, n_importance=8)
    jm, tm = JRender(**cfg), TRender(**cfg)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(rays))
    load_flax_params(tm, np_tree(params))
    key = jax.random.PRNGKey(2)
    r_pdf, r_c, r_f, r_p = jax.random.split(key, 4)
    draws = {"perturb": jax.random.uniform(r_p, (N, 8)), "noise_c": jax.random.normal(r_c, (N, 8)),
             "pdf_u": jax.random.uniform(r_pdf, (N, 8)), "noise_f": jax.random.normal(r_f, (N, 16))}
    perturb, noise = (1.0, 0.7) if stochastic else (0.0, 0.0)
    shared = SharedSamples(monkeypatch).record()
    trays = _t(rays, True)
    tout = tm(trays, {k: _t(v) for k, v in draws.items()} if stochastic else None,
              perturb=perturb, noise_std=noise)
    cot = rng.randn(N, 3).astype(np.float32)
    (tout["fine"]["rgb"] + tout["coarse"]["rgb"]).backward(torch.from_numpy(cot))
    shared.replay()

    def f(p, r):
        out = jm.apply(p, r, rng=key, perturb=perturb, noise_std=noise)
        return out["fine"]["rgb"] + out["coarse"]["rgb"], out
    jo, pull, jout = jax.vjp(f, params, jnp.asarray(rays), has_aux=True)
    jp, jr = pull(jnp.asarray(cot))
    for name in ("coarse", "fine"):
        for k in ("rgb", "depth", "opacity"):
            assert rel(jout[name][k], tout[name][k].detach()) < ENC, (name, k)
    assert rel(jr, trays.grad) < ENC
    assert max(leaf_errors(jp["params"], tm).values()) < ENC


# -- DiffAugment and the flax layers ----------------------------------------------------
@pytest.mark.parametrize("policy", ["color", "translation", "cutout",
                                    "color,translation,cutout"])
def test_diff_augment(policy):
    rng = np.random.RandomState(13)
    x = rng.randn(3, 16, 12, 3).astype(np.float32)
    key = jax.random.PRNGKey(14)
    draws = {}
    k = key
    for p in policy.split(","):
        fns = {"color": ["brightness", "saturation", "contrast"], "translation": ["t"],
               "cutout": ["c"]}[p]
        for name in fns:
            k, sub = jax.random.split(k)
            if name == "t":
                r1, r2 = jax.random.split(sub)
                draws["ty"] = jax.random.randint(r1, (3, 1, 1), -2, 3)
                draws["tx"] = jax.random.randint(r2, (3, 1, 1), -2, 3)
            elif name == "c":
                r1, r2 = jax.random.split(sub)
                draws["oy"] = jax.random.randint(r1, (3, 1, 1), 0, 16 + 1)
                draws["ox"] = jax.random.randint(r2, (3, 1, 1), 0, 12 + 1)
            else:
                draws[name] = jax.random.uniform(sub, (3, 1, 1, 1))
    tdraws = {k_: torch.from_numpy(np.array(v)) for k_, v in draws.items()}
    f, g = _vjp(lambda a: JA.diff_augment(key, a, policy), lambda a: TA.diff_augment(a, tdraws, policy),
                [x], rng)
    assert f < MOVE and g[0] < MOVE
    shapes = TA.augment_draws(torch.Generator().manual_seed(0), x.shape, policy, "cpu")
    assert {k_: tuple(v.shape) for k_, v in shapes.items()} == \
        {k_: tuple(np.shape(v)) for k_, v in draws.items()}


def _flax_vjp(jm, tm, x, rng, **kw):
    params = jax.jit(lambda a: jm.init(jax.random.PRNGKey(0), a, **kw))(jnp.asarray(x))
    load_flax_params(tm, np_tree(params))
    out, pull = jax.vjp(jax.jit(lambda p, a: jm.apply(p, a, **kw)), params, jnp.asarray(x))
    cot = rng.randn(*out.shape).astype(np.float32)
    jp, jx = pull(jnp.asarray(cot))
    tx = _t(x, True)
    got = tm(tx)
    got.backward(torch.from_numpy(cot))
    return rel(out, got.detach()), rel(jx, tx.grad), max(leaf_errors(jp["params"], tm).values())


def test_layer_norm_attention_gelu():
    rng = np.random.RandomState(15)
    x = (rng.randn(2, 7, 32) * 3 + 1).astype(np.float32)
    assert max(_flax_vjp(nn.LayerNorm(), TL.LayerNorm(32), x, rng)) < SUM

    class MHA(nn.Module):
        @nn.compact
        def __call__(self, h):
            return nn.MultiHeadDotProductAttention(num_heads=4)(h, h)

    class TMHA(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.MultiHeadDotProductAttention_0 = TL.MultiHeadDotProductAttention(32, 4)

        def forward(self, h):
            return self.MultiHeadDotProductAttention_0(h)
    assert max(_flax_vjp(MHA(), TMHA(), x, rng)) < SUM
    f, g = _vjp(nn.gelu, TL.gelu, [x], rng)
    assert f < MOVE and g[0] < MOVE


@pytest.mark.parametrize("train", [True, False])
def test_spectral_norm(train):
    """flax's SpectralNorm around a Conv, both modes: one power step from the
    stored ``u``, the kernel over sigma = v^T W u (the gradient through
    sigma), and the new ``u``/``sigma`` stored only with ``update_stats``."""
    rng = np.random.RandomState(16)

    class SN(nn.Module):
        @nn.compact
        def __call__(self, h, train):
            return nn.SpectralNorm(nn.Conv(6, (4, 4), strides=(2, 2), padding=((1, 1), (1, 1)),
                                           use_bias=False))(h, update_stats=train)
    x = rng.randn(2, 8, 8, 5).astype(np.float32)
    jm = SN()
    var = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    stats = var["batch_stats"]["SpectralNorm_0"]
    stats = dict(stats, **{"Conv_0/kernel/sigma": jnp.float32(2.5)})

    def f(p, a):
        return jm.apply({"params": p, "batch_stats": {"SpectralNorm_0": stats}}, a, train=train,
                        mutable=["batch_stats"])
    out_only, pull, (_, new) = jax.vjp(lambda p, a: (f(p, a)[0], f(p, a)), var["params"],
                                       jnp.asarray(x), has_aux=True)
    cot = rng.randn(*out_only.shape).astype(np.float32)
    jp, jx = pull(jnp.asarray(cot))

    conv = TL.Conv(5, 6, (4, 4), strides=2, padding=[(1, 1), (1, 1)], use_bias=False)
    load_flax_params(conv, np_tree(var["params"]["Conv_0"]))
    tx = _t(x, True)
    u = torch.from_numpy(np.array(stats["Conv_0/kernel/u"]))
    w, tnew = TL.spectral_normalize(conv.weight, {"u": u, "sigma": torch.tensor(2.5)},
                                    update_stats=train)
    got = conv(tx, weight=w)
    got.backward(torch.from_numpy(cot))
    assert rel(out_only, got.detach()) < SUM and rel(jx, tx.grad) < SUM
    assert max(leaf_errors(jp["Conv_0"], conv).values()) < SUM
    jn = new["batch_stats"]["SpectralNorm_0"]
    assert rel(jn["Conv_0/kernel/u"], tnew["u"]) < SUM
    assert rel(jn["Conv_0/kernel/sigma"], tnew["sigma"]) < SUM
    if not train:
        assert float(tnew["sigma"]) == 2.5 and torch.equal(tnew["u"], u)


# -- the discriminator and the inversion net -------------------------------------------
@pytest.mark.parametrize("imsize,conditional", [(16, True), (32, True), (64, True), (128, True),
                                                (32, False)])
def test_discriminator(imsize, conditional):
    """Logits, new spectral-norm state and the VJP (input and weights),
    DiffAugment on (the gate open) with JAX's draws."""
    from gnerf_helpers import _disc
    rng = np.random.RandomState(17)
    B, ndf = 2, 8
    x = rng.uniform(-1, 1, (B, imsize, imsize, 3)).astype(np.float32)
    y = rng.uniform(0.2, 1, (B, 1)).astype(np.float32)
    jm = JDisc(conditional=conditional, ndf=ndf, imsize=imsize)
    var = jax.jit(lambda a: jm.init(jax.random.PRNGKey(0), a, y=jnp.asarray(y), train=False))(
        jnp.asarray(x))
    tm = TDisc(conditional=conditional, ndf=ndf, imsize=imsize)
    load_flax_params(tm, np_tree(var["params"]))
    key = jax.random.PRNGKey(3)
    draws = _disc(key, x.shape)
    while draws["gate"] <= 0.5:      # the augmented branch
        key = jax.random.split(key)[0]
        draws = _disc(key, x.shape)

    def f(p, a):
        out, st = jm.apply({"params": p, "batch_stats": var["batch_stats"]}, a, y=jnp.asarray(y),
                           rng=key, train=True, mutable=["batch_stats"])
        return out, st["batch_stats"]
    out, pull, new = jax.vjp(jax.jit(f), var["params"], jnp.asarray(x), has_aux=True)
    cot = rng.randn(B).astype(np.float32)
    jp, jx = pull(jnp.asarray(cot))
    tstats = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), var["batch_stats"])
    tx = _t(x, True)
    got, tnew = tm(tx, _t(y), tstats, {k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
    got.backward(torch.from_numpy(cot))
    assert rel(out, got.detach()) < SUM and rel(jx, tx.grad) < SUM
    assert max(leaf_errors(jp, tm).values()) < SUM
    for (p, a), b in zip(jax.tree_util.tree_leaves_with_path(np_tree(new)),
                         jax.tree_util.tree_leaves(tnew)):
        assert rel(a, b) < SUM, jax.tree_util.keystr(p)


@pytest.mark.parametrize("imsize,mode", [(16, "6d"), (64, "3d")])
def test_inversion_net(imsize, mode):
    rng = np.random.RandomState(18)
    x = rng.uniform(-1, 1, (2, imsize, imsize, 3)).astype(np.float32)
    jm = JInv(imsize=imsize, pose_mode=mode, depth=2)
    tm = TInv(imsize=imsize, pose_mode=mode, depth=2)
    assert max(_flax_vjp(jm, tm, x, rng)) < SUM


def test_cumprod_backward_is_autograds():
    """The transmittance's cumprod keeps autograd's zero-free gradient
    formula, bit for bit, without autograd's check for zeros (a read of the
    device in every training step)."""
    x = (torch.rand(6, 11, generator=torch.Generator().manual_seed(0)) + 1e-3).requires_grad_()
    g = torch.randn(6, 11, generator=torch.Generator().manual_seed(1))
    (want,) = torch.autograd.grad(torch.cumprod(x, -1), x, g)
    out = TR._CumprodNonzero.apply(x)
    (got,) = torch.autograd.grad(out, x, g)
    assert torch.equal(out, torch.cumprod(x, -1)) and torch.equal(got, want)
