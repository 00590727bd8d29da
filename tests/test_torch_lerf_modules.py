"""LERF's modules in the port against their JAX twins, on the CPU: the same
numpy-seeded inputs and weights (carried by ``utils/from_flax.py``),
forward and VJP.

Tolerances: the hash indices, ``jnp.linspace`` and the renderers' shapes
are exact; float32 modules agree to float32 rounding (``ATOL`` 1e-5 on
O(1) values, gradients to ``GRAD_RTOL`` 1e-5 of a leaf's norm): the hash
grid sums its 8 corners with ``sum`` where JAX adds them one by one, and
the matmuls' summation orders differ.  ``trunc_exp`` is exact in float32
beyond +-15.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep3dmap_tpu.core.renderer import renderer_lerf as jrl
from deep3dmap_tpu.core.renderer.renderer_nfvr import sample_pdf as jax_sample_pdf
from deep3dmap_tpu.models.modulars import clip_encoder as jclip
from deep3dmap_tpu.models.modulars import hash_nerf as jhn
from deep3dmap_tpu.models.modulars import hashgrid as jhash
from deep3dmap_tpu.models.modulars.lerf_field import LERFField as JLERFField
from deep3dmap_tpu_torch.core.renderer import renderer_lerf as trl
from deep3dmap_tpu_torch.core.renderer.renderer_nfvr import sample_pdf_differentiable
from deep3dmap_tpu_torch.models.frameworks.lerf import linspace01
from deep3dmap_tpu_torch.models.modulars import clip_encoder as tclip
from deep3dmap_tpu_torch.models.modulars import hash_nerf as thn
from deep3dmap_tpu_torch.models.modulars.hashgrid import HashGridEncoding, hash_coords
from deep3dmap_tpu_torch.models.modulars.lerf_field import LERFField
from deep3dmap_tpu_torch.ops.resize import resize_bicubic, resize_bilinear
from deep3dmap_tpu_torch.utils.from_flax import load_flax_params, to_flax_grads

torch.set_num_threads(2)
ATOL = 1e-5
GRAD_RTOL = 1e-5


@pytest.fixture
def rs():
    return np.random.RandomState(0)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def assert_grads(jgrads, module, rtol=GRAD_RTOL):
    """Each leaf of the port's gradient within ``rtol`` of JAX's leaf norm."""
    got = dict(_leaves(to_flax_grads(module)))
    want = dict(_leaves(jgrads["params"] if "params" in jgrads else jgrads))
    assert {jax.tree_util.keystr(k) for k in got} == {jax.tree_util.keystr(k) for k in want}
    for k, w in want.items():
        g = [v for kk, v in got.items() if jax.tree_util.keystr(kk) == jax.tree_util.keystr(k)][0]
        w = np.asarray(w)
        scale = max(float(np.linalg.norm(w)), 1e-12)
        assert float(np.linalg.norm(g - w)) <= rtol * scale, jax.tree_util.keystr(k)


def t(a, grad=False):
    x = torch.from_numpy(np.array(a, np.float32))
    return x.requires_grad_(grad)


def test_hash_indices_bitwise(rs):
    """Coordinates over the whole int32 range (negative ones too) and the
    small ones the grids give: the uint32 products wrap, the indices are
    JAX's bit for bit."""
    big = rs.randint(-2 ** 31, 2 ** 31 - 1, size=(4096, 3), dtype=np.int64).astype(np.int32)
    small = rs.randint(0, 1100, size=(4096, 3)).astype(np.int32)
    edge = np.array([[2 ** 31 - 1] * 3, [-2 ** 31] * 3, [-1, 0, 1], [0, 0, 0]], np.int32)
    coords = np.concatenate([big, small, edge])
    for size in (2 ** 10, 2 ** 14, 2 ** 19, 12345):
        want = np.asarray(jhash._hash(jnp.asarray(coords), size))
        got = hash_coords(torch.from_numpy(coords), size).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("levels,feats,log2,base,end", [(4, 2, 8, 4, 64), (3, 8, 10, 16, 128)])
def test_hashgrid_forward_and_vjp(rs, levels, feats, log2, base, end):
    """A small table (collisions) and the LERF field's 8 features."""
    x = rs.rand(3, 40, 3).astype(np.float32)
    enc = jhash.HashGridEncoding(n_levels=levels, features_per_level=feats,
                                 log2_hashmap_size=log2, base_res=base, end_res=end)
    p = enc.init(jax.random.PRNGKey(1), jnp.asarray(x))
    p = jax.tree_util.tree_map(lambda a: a + 0.3 * jax.random.normal(jax.random.PRNGKey(2),
                                                                     a.shape), p)
    y, vjp = jax.vjp(lambda p, x: enc.apply(p, x), p, jnp.asarray(x))
    ct = rs.randn(*y.shape).astype(np.float32)
    gp, gx = vjp(jnp.asarray(ct))
    m = HashGridEncoding(levels, feats, log2, base, end)
    load_flax_params(m, jax.tree_util.tree_map(np.asarray, p))
    assert m.resolutions == [int(np.floor(base * np.exp((np.log(end) - np.log(base))
                                                         / (levels - 1)) ** l))
                             for l in range(levels)]
    xt = t(x, True)
    yt = m(xt)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), atol=ATOL)
    yt.backward(torch.from_numpy(ct))
    assert_grads(gp, m)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-4)


def test_trunc_exp_gradient_beyond_15():
    x = np.array([-40.0, -15.5, -15.0, -1.0, 0.0, 3.0, 15.0, 15.5, 40.0], np.float32)
    y, g = jax.value_and_grad(lambda v: jnp.sum(jhn.trunc_exp(v) * jnp.arange(1.0, 10.0)))(
        jnp.asarray(x))
    xt = t(x, True)
    yt = (thn.trunc_exp(xt) * torch.arange(1.0, 10.0)).sum()
    yt.backward()
    np.testing.assert_allclose(float(yt), float(y), rtol=1e-6)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(g))
    assert float(xt.grad[-1]) == pytest.approx(9 * np.exp(np.float32(15.0)), rel=1e-6)


def test_posenc(rs):
    x = rs.randn(5, 7, 3).astype(np.float32)
    np.testing.assert_allclose(thn.posenc(t(x), 4).numpy(),
                               np.asarray(jhn.posenc(jnp.asarray(x), 4)), atol=1e-6)


def _vjp_pair(jmod, tmod, inputs, rs, init_inputs=None):
    """JAX apply and VJP of ``jmod`` and the port module on the same
    weights; returns (jax outputs, port outputs, jax grads, port inputs)."""
    jin = [jnp.asarray(a) for a in inputs]
    p = jmod.init(jax.random.PRNGKey(3), *([jnp.asarray(a) for a in init_inputs]
                                           if init_inputs else jin))
    y = jax.jit(jmod.apply)(p, *jin)
    cts = jax.tree_util.tree_map(lambda a: jnp.asarray(rs.randn(*a.shape).astype(np.float32)), y)
    grads = jax.jit(lambda p, c, *a: jax.vjp(lambda p, *a: jmod.apply(p, *a), p, *a)[1](c))(
        p, cts, *jin)
    load_flax_params(tmod, jax.tree_util.tree_map(np.asarray, p))
    tin = [t(a, True) for a in inputs]
    ty = tmod(*tin)
    flat_t = ty if isinstance(ty, (tuple, list)) else [ty]
    flat_j = y if isinstance(y, (tuple, list)) else [y]
    flat_c = cts if isinstance(cts, (tuple, list)) else [cts]
    torch.autograd.backward(list(flat_t), [torch.from_numpy(np.asarray(c)) for c in flat_c])
    for a, b in zip(flat_t, flat_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=ATOL, rtol=1e-5)
    return grads, tin


def test_hash_nerf_field_and_proposal(rs):
    xyz = rs.rand(64, 8, 3).astype(np.float32)
    dirs = rs.randn(64, 8, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    kw = dict(n_levels=4, log2_hashmap_size=10, end_res=64, hidden=32)
    m = thn.HashNerfField(**kw)
    grads, tin = _vjp_pair(jhn.HashNerfField(**kw), m, [xyz, dirs], rs)
    assert_grads(grads[0], m)
    np.testing.assert_allclose(tin[1].grad.numpy(), np.asarray(grads[2]), atol=1e-4)
    prop = thn.ProposalDensityField(log2_hashmap_size=8, end_res=32)
    grads, tin = _vjp_pair(jhn.ProposalDensityField(log2_hashmap_size=8, end_res=32), prop,
                           [xyz], rs)
    assert_grads(grads[0], prop)


def _edges(rs, n, k, lo=0.5, hi=4.0):
    z = np.sort(rs.uniform(lo, hi, (n, k)), -1).astype(np.float32)
    return z


def test_weights_from_sigmas_and_interlevel_loss(rs):
    N, P, S = 32, 12, 9
    sig = rs.rand(N, P).astype(np.float32) * 3
    z = _edges(rs, N, P)
    (w, vjp) = jax.vjp(jhn.weights_from_sigmas, jnp.asarray(sig), jnp.asarray(z))
    ct = rs.randn(N, P).astype(np.float32)
    gs, gz = vjp(jnp.asarray(ct))
    st, zt = t(sig, True), t(z, True)
    wt = thn.weights_from_sigmas(st, zt)
    wt.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(wt.detach().numpy(), np.asarray(w), atol=1e-6)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gs), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(gz), atol=1e-5, rtol=1e-5)

    t_prop = np.concatenate([np.full((N, 1), 0.5, np.float32), _edges(rs, N, P - 1),
                             np.full((N, 1), 4.0, np.float32)], -1)
    w_prop = rs.rand(N, P).astype(np.float32) / P
    t_final = np.concatenate([np.full((N, 1), 0.4, np.float32), _edges(rs, N, S - 1),
                              np.full((N, 1), 4.2, np.float32)], -1)
    t_final[0, 3] = t_prop[0, 5]          # a query on an edge: side="left" decides
    t_final[0] = np.sort(t_final[0])
    w_final = rs.rand(N, S).astype(np.float32) / S
    loss, g = jax.value_and_grad(jhn.interlevel_loss, argnums=(1, 2, 3))(
        *map(jnp.asarray, (t_prop, w_prop, t_final, w_final)))
    tin = [t(t_prop), t(w_prop, True), t(t_final, True), t(w_final, True)]
    lt = thn.interlevel_loss(*tin)
    lt.backward()
    np.testing.assert_allclose(float(lt), float(loss), rtol=1e-5)
    for a, b in zip(tin[1:], g):
        got = a.grad if a.grad is not None else torch.zeros_like(a)
        np.testing.assert_allclose(got.numpy(), np.asarray(b), atol=1e-6, rtol=1e-4)


def test_sample_pdf_gradient_reaches_weights(rs):
    """The hash path's proposal samples keep JAX's gradient to the weights
    (the cdf stopped only for ``searchsorted``)."""
    N, P, K = 16, 10, 12
    bins = np.concatenate([np.full((N, 1), 0.5, np.float32), _edges(rs, N, P - 1),
                           np.full((N, 1), 4.0, np.float32)], -1)
    w = (rs.rand(N, P) ** 4).astype(np.float32)
    key = jax.random.PRNGKey(5)
    u = np.asarray(jax.random.uniform(key, (N, K)))
    z, vjp = jax.vjp(lambda w: jax_sample_pdf(key, jnp.asarray(bins), w + 1e-5, K),
                     jnp.asarray(w))
    ct = rs.randn(N, K).astype(np.float32)
    (gw,) = vjp(jnp.asarray(ct))
    wt = t(w, True)
    zt = sample_pdf_differentiable(t(bins), wt + 1e-5, torch.from_numpy(u))
    zt.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(zt.detach().numpy(), np.asarray(z), atol=1e-5)
    assert float(np.abs(np.asarray(gw)).sum()) > 0
    err = np.abs(wt.grad.numpy() - np.asarray(gw)).max() / np.abs(np.asarray(gw)).max()
    assert err < 1e-5, err


def test_lerf_field_and_renderers(rs):
    kw = dict(grid_layers=(2, 3), grid_sizes=(8, 9), grid_resolutions=((4, 16), (16, 32)),
              clip_n_dims=24, dino_n_dims=16, hidden=32)
    pos = rs.rand(10, 4, 3).astype(np.float32)
    scales = rs.rand(10, 4, 1).astype(np.float32)
    jm, m = JLERFField(**kw), LERFField(**kw)
    p = jm.init(jax.random.PRNGKey(4), jnp.asarray(pos), jnp.asarray(scales))
    load_flax_params(m, jax.tree_util.tree_map(np.asarray, p))

    def jf(p, a, b):
        o = jm.apply(p, a, b)
        return o["clip"], o["dino"], o["hashgrid"]
    y = jax.jit(jf)(p, jnp.asarray(pos), jnp.asarray(scales))
    cts = [rs.randn(*a.shape).astype(np.float32) for a in y]
    gp, _, gsc = jax.jit(lambda p, c, a, b: jax.vjp(jf, p, a, b)[1](c))(
        p, tuple(map(jnp.asarray, cts)), jnp.asarray(pos), jnp.asarray(scales))
    st = t(scales, True)
    o = m(t(pos), st)
    ty = (o["clip"], o["dino"], o["hashgrid"])
    torch.autograd.backward(list(ty), [torch.from_numpy(c) for c in cts])
    for a, b in zip(ty, y):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=ATOL)
    assert_grads(gp, m)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gsc), atol=1e-5, rtol=1e-4)
    # the relevancy sweep's reuse of the grid features
    feats = o["hashgrid"].detach()
    want = jm.apply(p, jnp.asarray(feats.numpy()), jnp.asarray(scales),
                    method=JLERFField.clip_from_hashgrid)
    np.testing.assert_allclose(m.clip_from_hashgrid(feats, t(scales)).detach().numpy(),
                               np.asarray(want), atol=ATOL)

    e = rs.randn(6, 5, 24).astype(np.float32)
    w = rs.rand(6, 5, 1).astype(np.float32)
    w[0] = 0.0                        # a ray with no weight: the eps inside the sqrt
    for jf, tf in ((jrl.render_clip, trl.render_clip), (jrl.render_mean, trl.render_mean)):
        y, vjp = jax.vjp(jf, jnp.asarray(e), jnp.asarray(w))
        ct = rs.randn(*y.shape).astype(np.float32)
        ge, gw = vjp(jnp.asarray(ct))
        et, wt = t(e, True), t(w, True)
        yt = tf(et, wt)
        yt.backward(torch.from_numpy(ct))
        np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), atol=1e-6)
        np.testing.assert_allclose(et.grad.numpy(), np.asarray(ge), atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), atol=1e-4, rtol=1e-5)
        assert np.isfinite(et.grad.numpy()).all()


def test_compact_clip_and_relevancy(rs, tmp_path):
    """The compact towers on JAX's weights (the ``image``/``text`` npz
    layout both encoders read), the text embeddings of the hashed tokens
    (one process: Python's ``hash`` agrees) and the relevancy."""
    j = jclip.CLIPEncoder(embed_dim=32, seed=3)
    path = str(tmp_path / "clip_small.npz")
    np.savez(path, image=np.array(jax.tree_util.tree_map(np.asarray, j.image_params),
                                  dtype=object),
             text=np.array(jax.tree_util.tree_map(np.asarray, j.text_params), dtype=object))
    m = tclip.CLIPEncoder(embed_dim=32, weights_path=path, device="cpu")
    np.testing.assert_allclose(m.neg_embeds.numpy(), np.asarray(j.neg_embeds), atol=ATOL)
    img = rs.rand(3, 64, 64, 3).astype(np.float32)
    np.testing.assert_allclose(m.encode_image(t(img)).numpy(),
                               np.asarray(j.encode_image(jnp.asarray(img))), atol=ATOL)
    phrases = ["red chair", "a blue sphere on the floor"]
    np.testing.assert_array_equal(tclip.simple_tokenize(phrases[1]),
                                  jclip.simple_tokenize(phrases[1]))
    j.set_positives(phrases)
    m.set_positives(phrases)
    emb = rs.randn(7, 5, 32).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    for i in range(2):
        np.testing.assert_allclose(m.get_relevancy(t(emb), i).numpy(),
                                   np.asarray(j.get_relevancy(jnp.asarray(emb), i)), atol=ATOL)


def test_linspace_and_resizes_match_jax(rs):
    for stop in (1.0, 2.0, 0.5):
        for n in (2, 5, 8, 16, 17, 30, 49, 97):
            np.testing.assert_array_equal(linspace01(stop, n, "cpu").numpy(),
                                          np.asarray(jnp.linspace(0.0, stop, n)))
    # DINO's (28² -> 4², 50², 4x6) and CLIP's (14² -> 7², 28²) position grids
    for g, hw, method in ((28, (4, 4), "bicubic"), (28, (50, 50), "bicubic"),
                          (28, (4, 6), "bicubic"), (14, (7, 7), "bilinear"),
                          (14, (28, 28), "bilinear")):
        x = rs.randn(1, g, g, 8).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), (1, *hw, 8), method))
        fn = resize_bicubic if method == "bicubic" else resize_bilinear
        np.testing.assert_allclose(fn(t(x), hw).numpy(), want, atol=ATOL)
