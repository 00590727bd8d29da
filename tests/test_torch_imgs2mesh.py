"""imgs2mesh in the port against the JAX package, on the CPU.

- The rotations both ways (1e-6), ``param2points_bfm`` (1e-6 relative, the
  einsums in JAX's order), the UV rasterization (identical arrays), vertex
  visibility (identical), ``sample_uv_texture`` (1e-5, and its gradient
  with respect to ``face_project`` 1e-4 of its norm).
- ``Vgg`` and ``Shape3dmmEncoder`` on flax params carried over (1e-5
  relative to the output's scale), and the port's init rule (``fc2`` and
  ``fc4`` from normal(1e-4)).
- ``Imgs2Mesh``: every log var in ``sup`` with and without sampling and in
  ``sup_unsup`` with sampling (1e-4 relative), every parameter's gradient
  (1e-3 of the leaf's norm), one jitted JAX call for all of them; the V
  views batched through the encoder give what one call per view gives.
- ``SyntheticFaceTupleDataset`` and ``MultiPIEFaceTupleDataset`` (the
  fixture of ``tests/test_real_configs.py``) item for item.
- The reference quirk: ``configs/pt3d_demos/imgs2face_multipie.py``'s
  ``use_sampling=True`` reads ``batch["uvtex"]`` in ``sup``, which the
  MultiPIE reader does not give: both sides raise ``KeyError``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep3dmap_tpu.core.all3dmm import bfm_tools as JB
from deep3dmap_tpu.core.all3dtrans import lmk2angle as JA
from deep3dmap_tpu.core.all3dtrans import rotations as JR
from deep3dmap_tpu.core.renderer import uv_sampler as JU
from deep3dmap_tpu.datasets import face_tuple as JD
from deep3dmap_tpu.datasets.builder import NumpyLoader as JLoader
from deep3dmap_tpu.models.backbones.shape_encoder import Shape3dmmEncoder as JEnc
from deep3dmap_tpu.models.backbones.vgg import Vgg as JVgg
from deep3dmap_tpu.models.frameworks import imgs2mesh as JI
from deep3dmap_tpu_torch.core.all3dmm import bfm_tools as TB
from deep3dmap_tpu_torch.core.all3dtrans import lmk2angle as TA
from deep3dmap_tpu_torch.core.all3dtrans import rotations as TR
from deep3dmap_tpu_torch.core.renderer import uv_sampler as TU
from deep3dmap_tpu_torch.datasets import face_tuple as TD
from deep3dmap_tpu_torch.datasets.builder import NumpyLoader, build_dataset
from deep3dmap_tpu_torch.models.backbones.shape_encoder import Shape3dmmEncoder
from deep3dmap_tpu_torch.models.backbones.vgg import Vgg
from deep3dmap_tpu_torch.models.frameworks import imgs2mesh as TI
from deep3dmap_tpu_torch.utils.from_flax import load_flax_params, to_flax_grads
from test_real_configs import _multipie_fixture
from torch_slice_helpers import leaf_rel_errors

torch.set_num_threads(2)
S, V, B, NV, TEX = 32, 2, 2, 128, 16
CFG = dict(tuplesize=V, image_size=S, n_verts=NV, texture_size=TEX)
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_rotations_both_ways():
    ang = np.random.RandomState(0).uniform(-1.4, 1.4, (6, 3)).astype(np.float32)
    R = TR.euler_angles_to_matrix(_t(ang))
    np.testing.assert_allclose(R.numpy(), np.asarray(JR.euler_angles_to_matrix(ang)),
                               atol=1e-6, rtol=0)
    back = TR.matrix_to_euler_angles(R)
    np.testing.assert_allclose(back.numpy(), np.asarray(JR.matrix_to_euler_angles(
        jnp.asarray(R.numpy()))), atol=1e-6, rtol=0)
    np.testing.assert_allclose(back.numpy(), ang, atol=1e-5, rtol=0)
    for axis in "XYZ":
        np.testing.assert_allclose(TR._axis_rot(_t(ang[:, 0]), axis).numpy(),
                                   np.asarray(JR._axis_rot(jnp.asarray(ang[:, 0]), axis)),
                                   atol=1e-6, rtol=0)
    for Rm in np.asarray(R, np.float64):
        np.testing.assert_allclose(TA.matrix2angle(Rm), JA.matrix2angle(Rm), atol=0, rtol=0)
    flat = np.array([[0.0, 0, 1], [0, 1, 0], [-1, 0, 0]])     # the sy < 1e-6 branch
    assert TA.matrix2angle(flat) == JA.matrix2angle(flat)


def test_param2points_bfm():
    tm, jm = TB.make_synthetic_bfm(n_verts=NV), JB.make_synthetic_bfm(n_verts=NV)
    preds = np.random.RandomState(1).randn(3, tm.n_shape + tm.n_exp + 7).astype(np.float32)
    pts, pose = TB.param2points_bfm(tm, _t(preds))
    jpts, jpose = JB.param2points_bfm(jm, jnp.asarray(preds))
    assert pts.shape == (3, NV, 3) and pose.shape == (3, 7)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=1e-6,
                               atol=1e-6 * float(np.abs(jpts).max()))
    np.testing.assert_array_equal(pose.numpy(), np.asarray(jpose))


@pytest.fixture(scope="module")
def rast():
    bfm = TB.make_synthetic_bfm(n_verts=NV)
    uvs = np.random.RandomState(7).rand(NV, 2).astype(np.float32)
    return uvs, bfm.triangles.numpy(), TU.precompute_uv_rasterization(
        uvs, bfm.triangles.numpy(), TEX, device="cpu")


def test_uv_rasterization_identical(rast):
    uvs, tris, tr = rast
    jr = JU.precompute_uv_rasterization(uvs, tris, TEX)
    assert (tr.tri_id >= 0).float().mean() > 0.5
    for f in jr._fields:
        np.testing.assert_array_equal(getattr(tr, f).numpy(), np.asarray(getattr(jr, f)),
                                      err_msg=f)


def test_vertex_visibility_and_uv_sampling(rast):
    uvs, tris, tr = rast
    jr = JU.precompute_uv_rasterization(uvs, tris, TEX)
    rs = np.random.RandomState(2)
    normals = rs.randn(NV, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    angles = rs.uniform(-0.6, 0.6, (B, 3)).astype(np.float32)
    look = np.array([0.0, 0.0, 1.0], np.float32)
    vis = TU.vertex_visibility(_t(normals), _t(angles), _t(look))
    jvis = np.asarray(JU.vertex_visibility(jnp.asarray(normals), jnp.asarray(angles),
                                           jnp.asarray(look)))
    assert vis.dtype == torch.bool and 0 < float(vis.float().mean()) < 1
    np.testing.assert_array_equal(vis.numpy(), jvis)

    imgs = rs.rand(B, S, S, 3).astype(np.float32)
    # some projections fall off the image: those texels sample zero
    fp = rs.uniform(-0.05, 1.05, (B, NV, 2)).astype(np.float32)
    g = rs.randn(B, TEX, TEX, 3).astype(np.float32)

    def jax_fn(f):
        return JU.sample_uv_texture(jr, jnp.asarray(imgs), f, jnp.asarray(jvis))
    (juv, jmask), vjp = jax.vjp(jax_fn, jnp.asarray(fp))
    jgrad = np.asarray(vjp((jnp.asarray(g), jnp.zeros_like(jmask)))[0])
    tfp = _t(fp).requires_grad_()
    uvimg, mask = TU.sample_uv_texture(tr, _t(imgs), tfp, vis)
    np.testing.assert_array_equal(mask.detach().numpy(), np.asarray(jmask))
    np.testing.assert_allclose(uvimg.detach().numpy(), np.asarray(juv), atol=1e-5, rtol=0)
    (grad,) = torch.autograd.grad(uvimg, tfp, _t(g))
    assert float(np.abs(jgrad).max()) > 0
    assert np.linalg.norm(grad.numpy() - jgrad) <= 1e-4 * np.linalg.norm(jgrad)


@pytest.mark.parametrize("which", ["vgg", "encoder"])
def test_vgg_and_encoder_match_flax(which):
    x = np.random.RandomState(3).rand(3, S, S, 3).astype(np.float32)
    jnet, net = (JVgg(), Vgg()) if which == "vgg" else (JEnc(n_param=20), Shape3dmmEncoder(20))
    params = jnet.init(jax.random.PRNGKey(4), jnp.asarray(x))
    want = np.asarray(jnet.apply(params, jnp.asarray(x)))
    load_flax_params(net, _np(params))
    with torch.no_grad():
        got = net(_t(x)).numpy()
    assert got.shape == want.shape == ((3, 512) if which == "vgg" else (3, 27))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


def test_encoder_init_rule():
    net = Shape3dmmEncoder(228)
    net.init_weights(torch.Generator().manual_seed(0))
    for fc in (net.fc2, net.fc4):
        assert float(fc.weight.std()) < 2e-4 and float(fc.bias.abs().max()) == 0.0
    assert float(net.fc1.weight.std()) > 1e-2          # lecun-normal, fan-in 512
    assert float(net.feat_net.GroupNorm_0.weight.min()) == 1.0


# -- the framework -------------------------------------------------------------
@pytest.fixture(scope="module")
def batch():
    ds = JD.SyntheticFaceTupleDataset(n_samples=B, tuplesize=V, image_size=S, n_verts=NV)
    b = next(iter(JLoader(ds, batch_size=B, shuffle=False)))
    b["uvtex"] = np.random.RandomState(5).rand(B, TEX, TEX, 3).astype(np.float32)
    return b


RUNS = (("sup", True), ("sup_unsup", True), ("sup", False))


@pytest.fixture(scope="module")
def jax_run(batch):
    """One jitted JAX call: each run's loss, log vars and gradients."""
    fws = {s: JI.Imgs2Mesh(dict(CFG, use_sampling=s)) for s in (True, False)}
    params, _ = fws[True].init(jax.random.PRNGKey(0), batch)

    def run(p, b):
        out = []
        for state, sampling in RUNS:
            fn = lambda q: fws[sampling].loss_fn(q, {}, b, None, state=state)  # noqa: E731
            (loss, aux), g = jax.value_and_grad(fn, has_aux=True)(p)
            out.append((loss, aux["log_vars"], g))
        return out

    res = jax.jit(run)(params, batch)
    return _np(params), [dict(loss=float(l), logs={k: float(v) for k, v in lv.items()},
                              grads=_np(g)["params"]) for l, lv, g in res]


def test_losses_and_gradients_match_jax(batch, jax_run):
    params, runs = jax_run
    fws = {s: TI.Imgs2Mesh(dict(CFG, use_sampling=s), device="cpu") for s in (True, False)}
    for (state, sampling), want in zip(RUNS, runs):
        fw = fws[sampling]
        net = fw.load_flax(params)
        net.zero_grad()
        loss, aux = fw.loss_fn(net, {}, batch, state=state)
        logs = aux["log_vars"]
        assert sorted(logs) == list(want["logs"]), (state, sampling)   # jit sorts keys
        np.testing.assert_allclose(float(loss), want["loss"], rtol=LOSS_RTOL)
        for k, v in logs.items():
            np.testing.assert_allclose(float(v), want["logs"][k], rtol=LOSS_RTOL,
                                       err_msg=f"{state} {sampling} {k}")
        loss.backward()
        errs = leaf_rel_errors(want["grads"], to_flax_grads(net))
        worst = max(errs, key=errs.get)
        assert errs[worst] <= GRAD_RTOL, (state, sampling, worst, errs[worst])
    assert {"texloss"} <= set(runs[0]["logs"]) and "tex_consistent_loss" in runs[1]["logs"]


def test_views_batched_equal_one_call_per_view(batch, jax_run):
    fw = TI.Imgs2Mesh(dict(CFG, use_sampling=False), device="cpu")
    net = fw.load_flax(jax_run[0])
    with torch.no_grad():
        pts, pose = fw._forward(net, _t(batch["imgs"]))
        for k in range(V):
            preds = net(_t(batch["imgs"][:, k]))
            p, q = TB.param2points_bfm(fw.bfm, preds)
            np.testing.assert_allclose(pose[k].numpy(), q.numpy(), rtol=0, atol=1e-6)
            np.testing.assert_allclose(pts[k].numpy(), torch.clamp(p, -1.25e5, 1.25e5).numpy(),
                                       rtol=0, atol=1e-6 * float(p.abs().max()))
    out, state = fw.forward_test(net, {}, batch)
    assert state == {} and len(out["outpts_list"]) == V and out["outpose_list"][0].shape == (B, 7)
    fw.on_state_switch("sup_unsup")
    assert set(fw.val_fn(net, {}, batch)["log_vars"]) == {"pts_consistent_loss",
                                                         "scale_consistent_loss"}


# -- the datasets -------------------------------------------------------------
def test_synthetic_face_tuple_dataset_matches_jax():
    ds = build_dataset(dict(type="SyntheticFaceTupleDataset", n_samples=2, tuplesize=3,
                            image_size=16, n_verts=NV, seed=4))
    jds = JD.SyntheticFaceTupleDataset(n_samples=2, tuplesize=3, image_size=16, n_verts=NV,
                                       seed=4)
    assert ds.state == "sup" and len(ds) == 2
    for i in range(2):
        got, want = ds[i], jds[i]
        np.testing.assert_array_equal(got["imgs"], want["imgs"])
        np.testing.assert_allclose(got["gtobj"], want["gtobj"], rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want["gtobj"]).max()))
        # lm68 in pixels, then s, R, t and the angles
        np.testing.assert_allclose(got["gtaux"], want["gtaux"], rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def multipie(tmp_path_factory):
    root = tmp_path_factory.mktemp("multipie")
    _multipie_fixture(root)
    return root


def _multipie_cfg(root, **kw):
    return dict(datadir=str(root), imgdir=str(root / "images"), objroot=str(root / "objs"),
                tuplesize=2, image_size=32, **kw)


def test_multipie_dataset_matches_jax(multipie):
    ds = build_dataset(dict(type="MultiPIEFaceTupleDataset", **_multipie_cfg(multipie, seed=3)),
                       default_args=dict(device="cpu"))
    jds = JD.MultiPIEFaceTupleDataset(**_multipie_cfg(multipie, seed=3))
    assert len(ds) == len(jds) == 3 and ds.entries == jds.entries
    for i in range(3):
        got, want = ds[i], jds[i]
        assert set(got) == set(want) == {"imgs", "gtobj", "gtaux"}
        assert got["imgs"].shape == (2, 32, 32, 3)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{i} {k}")
    np.testing.assert_array_equal(
        TD._read_obj_verts(str(multipie / "objs" / "001_01_01.obj")),
        JD._read_obj_verts(str(multipie / "objs" / "001_01_01.obj")))


def test_uvtex_quirk_raises_on_both_sides(multipie):
    """imgs2face_multipie.py's model on MultiPIE items: ``sup`` with
    sampling reads ``batch["uvtex"]``, which the reader does not give."""
    cfg = _multipie_cfg(multipie)
    jb = next(iter(JLoader(JD.MultiPIEFaceTupleDataset(**cfg), batch_size=2)))
    tb = next(iter(NumpyLoader(TD.MultiPIEFaceTupleDataset(**cfg), batch_size=2)))
    assert "uvtex" not in tb and set(tb) == set(jb)
    model = dict(tuplesize=2, image_size=32, n_verts=256, use_sampling=True)
    jfw = JI.Imgs2Mesh(model)
    params, _ = jfw.init(jax.random.PRNGKey(0), jb)
    with pytest.raises(KeyError, match="uvtex"):
        jfw.loss_fn(params, {}, jb, None)
    fw = TI.Imgs2Mesh(model, device="cpu")
    net, _ = fw.init(0, tb)
    with pytest.raises(KeyError, match="uvtex"):
        fw.loss_fn(net, {}, tb)
    # without sampling the same items train on both sides
    assert np.isfinite(float(TI.Imgs2Mesh(dict(model, use_sampling=False), device="cpu")
                             .loss_fn(net, {}, tb)[0]))
