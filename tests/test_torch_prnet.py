"""PRNet in the port against the JAX package, on the CPU.

- ``ResFCN256`` at R 64 on flax params carried over (``utils/from_flax.py``),
  base 4 and base 6 (whose 6- and 12-channel norms take 6 groups: JAX's
  ``_gn`` counts down from min(8, C) to a divisor, ``layers.num_groups``).
- ``FaceImg2UV``'s ``loss_fn`` and ``val_fn`` within 1e-5 relative, its
  ``forward_test`` and every parameter's gradient against
  ``jax.value_and_grad``; the JAX step is jitted once.
- ``bfm_uv_coords``, ``uv_kpt_ind_from_bfm`` and the synthetic BFM equal,
  ``eval_nme`` within 1e-6, the L1 losses and the ``LOSSES`` classes.
- ``SyntheticFaceUVDataset`` and ``ThreeHundredWLPDataset`` (``cv2``-written
  JPEG crops at 48² read at R 32: ``INTER_AREA`` images, ``INTER_LINEAR``
  UV maps times the scale) item for item and through ``evaluate``; the
  ``weightmaskfile`` branch reads an image file as ``cv2.imread`` does.

Tolerances, measured and then rounded up.  The outputs do not agree to
1e-5 abs, nor the gradients to 1e-4 of a leaf's norm, and the cause is
float32 rounding on both sides: each of the ~40 GroupNorms adds ~1e-6
relative (E[x²] - E[x]², summed in each framework's own order).  Against
a float64 evaluation of the port with the same weights, JAX's output is
3.0e-5 off and the port's 1.4e-5 (base 4), JAX's worst gradient leaf
3.9e-4 and the port's 2.5e-4; port against JAX: 3.3e-5 / 4.5e-5 (base 4 /
6), ``forward_test`` 7.0e-5, gradients 5.3e-4.  Each check also holds the
port no farther from the float64 evaluation than JAX is.
"""
import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep3dmap_tpu.core.all3dmm import bfm_tools as JB
from deep3dmap_tpu.core.evaluation.face_eval import eval_nme as j_eval_nme
from deep3dmap_tpu.datasets.face_uv import SyntheticFaceUVDataset as JSynth
from deep3dmap_tpu.datasets.real_files import ThreeHundredWLPDataset as J300
from deep3dmap_tpu.models.backbones.resfcn256 import ResFCN256 as JResFCN
from deep3dmap_tpu.models.frameworks import prnet as JP
from deep3dmap_tpu.models.losses import basic as JL
from deep3dmap_tpu_torch.core.all3dmm import bfm_tools as TB
from deep3dmap_tpu_torch.core.evaluation.face_eval import eval_nme
from deep3dmap_tpu_torch.datasets.builder import build_dataset
from deep3dmap_tpu_torch.models.backbones.resfcn256 import ResFCN256
from deep3dmap_tpu_torch.models.builder import LOSSES
from deep3dmap_tpu_torch.models.frameworks import prnet as TP
from deep3dmap_tpu_torch.models.losses import basic as TL
from deep3dmap_tpu_torch.utils.from_flax import load_flax_params, to_flax_grads
from torch_slice_helpers import leaf_rel_errors

torch.set_num_threads(2)
RES, BASE, B = 64, 4, 2
FWD_ATOL = 1e-4         # uvpos, kpt, the backbone's output
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3        # per leaf, of the leaf's norm


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    img = rs.rand(B, RES, RES, 3).astype(np.float32)
    uv = np.stack([img[..., 0], img[..., 1] * 0.5 + 0.2, img[..., 2]], -1)
    return {"faceimg": img, "gt_uvimg": uv.astype(np.float32)}


@pytest.mark.parametrize("base", [4, 6])
def test_resfcn256_forward_matches_flax(base):
    x = np.random.RandomState(base).rand(2, RES, RES, 3).astype(np.float32)
    jnet = JResFCN(out_ch=3, base=base)
    params = jnet.init(jax.random.PRNGKey(base), jnp.asarray(x))
    want = np.asarray(jnet.apply(params, jnp.asarray(x)))
    net = load_flax_params(ResFCN256(3, base), _np(params))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
        exact = net.double()(torch.from_numpy(x).double()).numpy()
    assert got.shape == (2, RES, RES, 3)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=0)
    assert np.abs(got - exact).max() <= np.abs(want - exact).max()


@pytest.fixture(scope="module")
def jax_run():
    """JAX's FaceImg2UV: init, and one jitted call giving the loss, its log,
    the gradients, val_fn and forward_test."""
    jfw = JP.FaceImg2UV(dict(resolution=RES, base_channels=BASE))
    batch = _batch()
    params, mstate = jfw.init(jax.random.PRNGKey(0), batch)

    def run(p, b):
        (loss, aux), g = jax.value_and_grad(jfw.loss_fn, has_aux=True)(p, {}, b, None)
        out, _ = jfw.forward_test(p, {}, b)
        return loss, aux["log_vars"], g, jfw.val_fn(p, {}, b)["log_vars"], out

    loss, logs, grads, val, out = jax.jit(run)(params, batch)
    return dict(params=_np(params), batch=batch, loss=float(loss),
                logs={k: float(v) for k, v in logs.items()}, grads=_np(grads)["params"],
                val={k: float(v) for k, v in val.items()},
                out={k: np.asarray(v) for k, v in out.items()})


@pytest.fixture(scope="module")
def port(jax_run):
    fw = TP.FaceImg2UV(dict(resolution=RES, base_channels=BASE), device="cpu")
    fw.init(0, jax_run["batch"])
    return fw, fw.load_flax(jax_run["params"])


def test_loss_val_forward_test_match_jax(jax_run, port):
    fw, net = port
    batch = jax_run["batch"]
    loss, aux = fw.loss_fn(net, {}, batch)
    np.testing.assert_allclose(float(loss), jax_run["loss"], rtol=LOSS_RTOL)
    assert set(aux["log_vars"]) == set(jax_run["logs"]) == {"loss_uv", "loss_kpt"}
    for k, v in aux["log_vars"].items():
        np.testing.assert_allclose(float(v), jax_run["logs"][k], rtol=LOSS_RTOL, err_msg=k)
    val = fw.val_fn(net, {}, batch)["log_vars"]
    assert set(val) == {"loss_uv"}
    np.testing.assert_allclose(float(val["loss_uv"]), jax_run["val"]["loss_uv"],
                               rtol=LOSS_RTOL)
    out, state = fw.forward_test(net, {}, batch)
    assert state == {} and out["kpt"].shape == (B, 3, 68)
    for k in ("uvpos", "kpt"):
        np.testing.assert_allclose(out[k].numpy(), jax_run["out"][k], atol=FWD_ATOL,
                                   rtol=0, err_msg=k)


def _grads(fw, net, batch):
    net.zero_grad()
    loss, _ = fw.loss_fn(net, {}, batch)
    loss.backward()
    return to_flax_grads(net)


def test_every_parameter_gradient_matches_jax(jax_run, port):
    fw, net = port
    got = _grads(fw, net, jax_run["batch"])
    errs = leaf_rel_errors(jax_run["grads"], got)
    assert len(errs) == sum(1 for _ in net.parameters())
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])

    # the same weights and loss in float64: the port is the nearer side
    fw64 = TP.FaceImg2UV(dict(resolution=RES, base_channels=BASE), device="cpu")
    net64 = fw64.load_flax(jax_run["params"]).double()
    fw64.weight_mask = fw64.weight_mask.double()
    fw64._t = lambda v: torch.as_tensor(v).double()
    exact = _grads(fw64, net64, jax_run["batch"])
    assert max(leaf_rel_errors(exact, got).values()) <= \
        max(leaf_rel_errors(exact, jax_run["grads"]).values())


def test_init_is_seeded_and_flax_shaped():
    fw = TP.FaceImg2UV(dict(resolution=RES, base_channels=BASE), device="cpu")
    a = {k: v.clone() for k, v in fw.init(3, None)[0].state_dict().items()}
    b = fw.init(3, None)[0].state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(fw.net.Conv_1.bias.abs().sum()) == 0.0     # flax's zero biases
    assert float(fw.net.GroupNorm_0.weight.min()) == 1.0


def test_uv_kpt_ind_and_synthetic_bfm_equal_jax():
    jm, tm = JB.make_synthetic_bfm(), TB.make_synthetic_bfm()
    for f in jm._fields:
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                      err_msg=f)
    for res in (32, 256):
        np.testing.assert_array_equal(TP.bfm_uv_coords(tm, res), JP.bfm_uv_coords(jm, res))
        np.testing.assert_array_equal(TP.uv_kpt_ind_from_bfm(None, res),
                                      JP.uv_kpt_ind_from_bfm(None, res))
    small = TB.make_synthetic_bfm(n_verts=40, n_tri=30, seed=4)     # 68 keypoints of 40
    np.testing.assert_array_equal(
        TP.uv_kpt_ind_from_bfm(small, 64),
        JP.uv_kpt_ind_from_bfm(JB.make_synthetic_bfm(n_verts=40, n_tri=30, seed=4), 64))


def test_kpt_sources_in_jax_order(tmp_path):
    ind = np.random.RandomState(1).randint(0, RES, (2, 68))
    path = tmp_path / "uv_kpt_ind.txt"
    np.savetxt(path, ind + 1)
    cfg = dict(resolution=RES, base_channels=BASE)
    for extra, want in ((dict(uv_kpt_ind=ind, uv_kpt_ind_file=str(path)), ind),
                        (dict(uv_kpt_ind_file=str(path)), ind + 1),
                        ({}, JP.uv_kpt_ind_from_bfm(None, RES))):
        fw = TP.FaceImg2UV(dict(cfg, **extra), device="cpu")
        np.testing.assert_array_equal(fw.uv_kpt_ind, want)
        np.testing.assert_array_equal(fw.uv_kpt_ind,
                                      JP.FaceImg2UV(dict(cfg, **extra)).uv_kpt_ind)


def test_weightmaskfile_reads_as_cv2(tmp_path):
    rs = np.random.RandomState(2)
    wm = rs.randint(0, 256, (RES, RES, 3), np.uint8)
    fm = rs.randint(0, 2, (RES, RES), np.uint8) * 255
    cv2.imwrite(str(tmp_path / "weight.png"), wm)
    cv2.imwrite(str(tmp_path / "face.png"), fm)
    cfg = dict(resolution=RES, base_channels=BASE, weightmaskfile=str(tmp_path / "weight.png"),
               facemaskfile=str(tmp_path / "face.png"))
    got = TP.FaceImg2UV(cfg, device="cpu").weight_mask.numpy()
    want = np.asarray(JP.FaceImg2UV(cfg).weight_mask)
    assert got.shape == (RES, RES, 1) and 0 < got.mean() < 1
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


def test_eval_nme_and_losses_match_jax():
    rs = np.random.RandomState(3)
    kpt = rs.rand(4, 3, 68)
    tf = np.tile(np.eye(3), (4, 1, 1)) + rs.randn(4, 3, 3) * 0.05
    tf[:, 2] = [0, 0, 1]
    gt = rs.rand(4, 2, 68) * 200
    np.testing.assert_allclose(eval_nme(kpt, tf, gt), j_eval_nme(kpt, tf, gt), atol=1e-6, rtol=0)

    p, t = rs.randn(3, 5).astype(np.float32), rs.randn(3, 5).astype(np.float32)
    w = rs.rand(3, 5).astype(np.float32)
    m = rs.rand(5).astype(np.float32)
    tp, tt, tw, tm = (torch.from_numpy(a) for a in (p, t, w, m))
    pairs = [(TL.l1_loss(tp, tt), JL.l1_loss(p, t)),
             (TL.l1_loss(tp, tt, tw, "sum"), JL.l1_loss(p, t, w, "sum")),
             (TL.l1_loss(tp, tt, avg_factor=4.0), JL.l1_loss(p, t, avg_factor=4.0)),
             (TL.smooth_l1_loss(tp, tt, beta=0.5), JL.smooth_l1_loss(p, t, beta=0.5)),
             (TL.mask_l1_loss(tp, tt, tm), JL.mask_l1_loss(p, t, m)),
             (LOSSES.build(dict(type="L1Loss", loss_weight=2.0))(tp, tt),
              JL.L1Loss(loss_weight=2.0)(p, t)),
             (LOSSES.build(dict(type="SmoothL1Loss"))(tp, tt), JL.SmoothL1Loss()(p, t)),
             (LOSSES.build(dict(type="MaskL1Loss", mask=tm))(tp, tt), JL.MaskL1Loss(m)(p, t))]
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6, err_msg=str(i))
    assert TL.l1_loss(tp, tt, reduction="none").shape == (3, 5)


def test_synthetic_face_uv_dataset_matches_jax():
    ds = build_dataset(dict(type="SyntheticFaceUVDataset", n_samples=3, resolution=32, seed=5),
                       default_args=dict(device="cpu"))
    jds = JSynth(n_samples=3, resolution=32, seed=5)
    for i in range(3):
        for k, v in jds[i].items():
            np.testing.assert_array_equal(ds[i][k], v, err_msg=k)
    kpt = [np.random.RandomState(6).rand(3, 3, 68).astype(np.float32)]
    np.testing.assert_allclose(ds.evaluate({"kpt": kpt})["nme"],
                               jds.evaluate({"kpt": kpt})["nme"], atol=1e-6, rtol=0)
    with pytest.raises(KeyError):
        ds.evaluate({"kpt": kpt}, metric="mae")


@pytest.fixture(scope="module")
def wlp_tree(tmp_path_factory):
    """300W-LP's layout at 48²: ``*_inp.jpg`` crops (JPEG, ``cv2``), ``.npy``
    UV maps in pixels, ``list.txt`` with one name lacking its files, and
    ``uv_kpt_ind.txt``."""
    root = tmp_path_factory.mktemp("300wlp")
    rs = np.random.RandomState(0)
    names = []
    yy, xx = np.meshgrid(np.arange(48.0), np.arange(48.0), indexing="ij")
    for i in range(5):
        cv2.imwrite(str(root / f"im{i}_inp.jpg"), rs.randint(0, 256, (48, 48, 3), np.uint8))
        uv = np.stack([xx, yy, 20 + 5 * np.sin(xx / 7 + i)], -1) + rs.rand(48, 48, 3)
        np.save(root / f"im{i}.npy", uv.astype(np.float32))
        names.append(f"im{i}.jpg")
    (root / "list.txt").write_text("\n".join(names + ["missing.jpg"]) + "\n\n")
    np.savetxt(root / "uv_kpt_ind.txt", TP.uv_kpt_ind_from_bfm(None, 32))
    return root


def test_300wlp_dataset_matches_jax(wlp_tree):
    kw = dict(datapath=str(wlp_tree / "list.txt"), img_prefix=str(wlp_tree), resolution=32,
              uv_kpt_ind_file=str(wlp_tree / "uv_kpt_ind.txt"))
    ds = build_dataset(dict(type="ThreeHundredWLPDataset", **kw),
                       default_args=dict(device="cpu"))
    jds = J300(**kw)
    assert len(ds) == len(jds) == 5
    for i in range(5):
        got, want = ds[i], jds[i]
        assert set(got) == set(want)
        assert got["faceimg"].shape == (32, 32, 3) and got["gt_uvimg"].dtype == np.float32
        for k in want:
            # cv2's float resize against the port's weight matrices: the
            # same weights summed in another order
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=f"{i} {k}")
    rs = np.random.RandomState(7)
    kpt = [rs.rand(3, 3, 68).astype(np.float32), rs.rand(2, 3, 68).astype(np.float32)]
    np.testing.assert_allclose(ds.evaluate({"kpt": kpt})["nme"],
                               jds.evaluate({"kpt": kpt})["nme"], rtol=1e-5)
    bare = build_dataset(dict(type="ThreeHundredWLPDataset", datapath=kw["datapath"],
                              img_prefix=kw["img_prefix"], resolution=32))
    with pytest.raises(ValueError, match="uv_kpt_ind_file"):
        bare.evaluate({"kpt": kpt})
