"""The published ScanNet config's training trunk (``BACKBONE2D.MODE="scan"``
with ``REMAT``) and ``BP_GRAD_FRAC`` through the whole NeuralRecon slice,
on the CPU in float32.  The port runs the views as one conv batch under
``checkpoint`` whatever MODE says, and takes ``BP_GRAD_FRAC`` as a no-op;
these tests hold both to JAX's scanned trunk and compacted backward.

- The trunk alone (``fpn-mnas-0.5``, 3 views at 32x48): the port's
  checkpointed batch against JAX's ``nn.scan(nn.remat(_FPNStep))`` on the
  same parameter tree, forward and the VJP in every parameter and in the
  images.  Measured: the forward 1.8e-5 apart (tolerance 1e-4, as
  ``tests/test_torch_modules.py::test_mnas_fpn``), the parameter gradient
  2.0e-4 of a leaf's norm (tolerance 5e-4).  That gap is JAX's float32
  rounding, not a rule: the port's gradient sits 1.9e-6 from the same trunk
  in float64, JAX's 2.0e-4, and JAX's own scan and batch forms agree to
  1.6e-6.  So the port is also held to its float64 twin (1e-5).  The
  image gradient likewise: JAX sits 8.1e-4 of its largest value from
  float64, the port 9.2e-7 (tolerances 2e-3 and 1e-5 of that value).
- The port's batch, with and without remat, against the views run one at
  a time through the same FPN (the scan's semantics): GroupNorm is per
  image, so the two differ only by the convs' batch size.  Measured on the
  CPU: outputs 7.6e-6 apart (tolerance 2e-5), gradients 8.5e-7 of a leaf's
  norm and 6.6e-7 of the largest image gradient (tolerance 1e-5); remat
  changes nothing, with the bf16 ``DTYPE`` too (the recompute casts as the
  forward did: bit-equal).
- The slice, dense 16³, 2 views: the port's default trunk (batch + remat)
  against JAX's default trunk (scan + remat), one ``loss_fn`` step with
  ``value_and_grad`` jitted once; the tolerances are
  ``tests/test_torch_neuralrecon_train.py``'s, whose docstring traces the
  gradient's spread.  Then ``BP_GRAD_FRAC`` 0.25 and ``MODE="batch"``
  against the defaults: bit-equal, as both are no-ops in the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as flax_nn

from deep3dmap_tpu.models.frameworks import neuralrecon as jax_nr
from deep3dmap_tpu_torch.models.frameworks import neuralrecon as torch_nr
from deep3dmap_tpu_torch.utils.from_flax import to_flax_grads, to_flax_params
from torch_slice_helpers import leaf_rel_errors, run_jax_train, train_fragments

torch.set_num_threads(2)

TRUNK_ATOL = 1e-4           # as tests/test_torch_modules.py::test_mnas_fpn
TRUNK_GRAD_RTOL = 5e-4
TRUNK_F64_RTOL = 1e-5
MODE_ATOL = 2e-5
MODE_GRAD_RTOL = 1e-5
LOSS_RTOL = 1e-5            # as tests/test_torch_neuralrecon_train.py
GRAD_RTOL = 5e-2
BACKBONE_GRAD_RTOL = 1e-1
GLOBAL_GRAD_RTOL = 2e-2

V, H, W = 3, 32, 48


@pytest.fixture(scope="module")
def trunk():
    """The port's trunk with its seeded weights, the inputs and a
    cotangent for each pyramid level."""
    from deep3dmap_tpu_torch.models.layers import init_flax_defaults

    m = torch_nr._FPNBatch(alpha=0.5, norm="gn", torch_pad=False, dtype=None)
    init_flax_defaults(m, torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)
    imgs = rs.randn(1, V, H, W, 3).astype(np.float32)
    with torch.no_grad():
        shapes = [tuple(f.shape) for f in m(torch.from_numpy(imgs), False)]
    cots = [rs.randn(*s).astype(np.float32) for s in shapes]
    return m, imgs, cots


def _per_view(m, x, remat):
    """The scan's semantics: each view alone through the FPN."""
    views = [m(x[:, v:v + 1], remat) for v in range(x.shape[1])]
    return [torch.cat([p[s] for p in views], dim=1) for s in range(len(views[0]))]


def _torch_vjp(m, imgs, cots, mode, remat):
    m.zero_grad()
    x = torch.from_numpy(imgs).requires_grad_()
    outs = _per_view(m, x, remat) if mode == "scan" else m(x, remat)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)).backward()
    return [o.detach().numpy() for o in outs], to_flax_grads(m), x.grad.numpy()


def test_scan_remat_trunk_matches_jax_scan(trunk):
    m, imgs, cots = trunk
    scan = flax_nn.scan(flax_nn.remat(jax_nr._FPNStep), variable_broadcast="params",
                        split_rngs={"params": False}, in_axes=0, out_axes=0)(
        alpha=0.5, norm="gn", torch_pad=False, dtype=None)
    params = jax.tree_util.tree_map(jnp.asarray, to_flax_params(m))

    def f(p, x):
        _, pyr = scan.apply({"params": p}, None, jnp.moveaxis(x, 1, 0))
        return [jnp.moveaxis(o, 0, 1) for o in pyr]

    want, vjp = jax.vjp(f, params, jnp.asarray(imgs))
    d_params, d_imgs = vjp([jnp.asarray(c) for c in cots])
    got, g_params, g_imgs = _torch_vjp(m, imgs, cots, "batch", True)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=TRUNK_ATOL, rtol=0)
    rel = leaf_rel_errors(jax.tree_util.tree_map(np.asarray, d_params), g_params)
    assert len(rel) > 20
    bad = {k: v for k, v in rel.items() if v > TRUNK_GRAD_RTOL}
    assert not bad, f"trunk leaves off JAX's scanned VJP: {bad}"
    scale = np.abs(g_imgs).max()
    np.testing.assert_allclose(g_imgs, np.asarray(d_imgs), atol=2e-3 * scale, rtol=0)
    m64 = torch_nr._FPNBatch(alpha=0.5, norm="gn", torch_pad=False, dtype=None).double()
    m64.load_state_dict(m.state_dict())
    x64 = torch.from_numpy(imgs).double().requires_grad_()
    outs = m64(x64, False)
    sum((o * torch.from_numpy(c).double()).sum() for o, c in zip(outs, cots)).backward()
    rel64 = leaf_rel_errors(to_flax_grads(m64), g_params)
    assert max(rel64.values()) <= TRUNK_F64_RTOL, max(rel64.items(), key=lambda kv: kv[1])
    np.testing.assert_allclose(g_imgs, x64.grad.numpy(), atol=TRUNK_F64_RTOL * scale, rtol=0)


def test_scan_and_batch_trunks_agree(trunk):
    m, imgs, cots = trunk
    runs = {(mode, remat): _torch_vjp(m, imgs, cots, mode, remat)
            for mode in ("scan", "batch") for remat in (True, False)}
    ref_out, ref_g, ref_x = runs[("batch", False)]
    for key, (out, g, x) in runs.items():
        for a, b in zip(out, ref_out):
            np.testing.assert_allclose(a, b, atol=MODE_ATOL, rtol=0, err_msg=str(key))
        rel = leaf_rel_errors(ref_g, g)
        assert max(rel.values()) <= MODE_GRAD_RTOL, (key, max(rel.values()))
        np.testing.assert_allclose(x, ref_x, atol=MODE_GRAD_RTOL * np.abs(ref_x).max(), rtol=0,
                                   err_msg=str(key))


@pytest.mark.parametrize("key", ["MODE", "INFER_MODE"])
def test_backbone_mode_keys_are_checked(key):
    """JAX's two values are accepted (both run the batch); others raise."""
    for ok in ("scan", "batch"):
        fw = torch_nr.NeuralRecon(dict(CFG, BACKBONE2D=dict(ARC="fpn-mnas-0.5", **{key: ok})),
                                  device="cpu")
        assert fw.net.backbone_remat
    with pytest.raises(ValueError, match=key):
        torch_nr.NeuralRecon(dict(CFG, BACKBONE2D=dict(ARC="fpn-mnas-0.5", **{key: "vmap"})),
                             device="cpu")


def test_remat_recompute_keeps_the_bf16_trunk(trunk):
    """``checkpoint`` recomputes the forward in the backward: with the
    trunk's bf16 ``DTYPE`` (``BACKBONE2D.DTYPE``) the recompute casts as
    the forward did, so remat changes no bit of the gradient."""
    from deep3dmap_tpu_torch.models.layers import init_flax_defaults

    _, imgs, cots = trunk
    m = torch_nr._FPNBatch(alpha=0.5, norm="gn", torch_pad=False, dtype=torch.bfloat16)
    init_flax_defaults(m, torch.Generator().manual_seed(0))
    runs = [_torch_vjp(m, imgs, cots, "batch", remat) for remat in (True, False)]
    for a, b in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(a, b)
    rel = leaf_rel_errors(runs[1][1], runs[0][1])
    assert len(rel) > 20 and max(rel.values()) == 0.0, max(rel.items(), key=lambda kv: kv[1])
    np.testing.assert_array_equal(runs[0][2], runs[1][2])


CFG = dict(N_LAYER=3, VOXEL_SIZE=0.08, N_VOX=[16, 16, 16],
           FUSION=dict(FUSION_ON=True, FULL=True), LW=[1.0, 0.8, 0.64],
           THRESHOLDS=[0, 0, 0], POS_WEIGHT=1.5, BACKBONE2D=dict(ARC="fpn-mnas-0.5"))


@pytest.fixture(scope="module")
def slice_runs():
    frags = train_fragments(16, 1)
    fw = torch_nr.NeuralRecon(CFG, device="cpu")
    fw.init(0, frags[0])
    assert fw.net.backbone_remat
    j, _ = run_jax_train(CFG, to_flax_params(fw.net), frags)
    return fw, frags, j[0]


def _port_step(fw, frags):
    fw.net.zero_grad()
    loss, aux = fw.loss_fn(fw.net, fw.init_state(1), frags[0])
    loss.backward()
    logs = {k: float(v.detach()) for k, v in aux["log_vars"].items()}
    return float(loss.detach()), logs, to_flax_grads(fw.net)


def test_slice_scan_trunk_matches_jax(slice_runs):
    fw, frags, j = slice_runs
    loss, logs, grads = _port_step(fw, frags)
    np.testing.assert_allclose(loss, j["loss"], rtol=LOSS_RTOL)
    for k, v in j["logs"].items():
        np.testing.assert_allclose(logs[k], v, rtol=LOSS_RTOL, err_msg=k)
    rel = leaf_rel_errors(j["grads"], grads)
    bad = {k: v for k, v in rel.items()
           if v > (BACKBONE_GRAD_RTOL if k.startswith("backbone2d/") else GRAD_RTOL)}
    assert not bad, f"leaves off JAX's gradient: {bad}"
    whole = leaf_rel_errors({"g": _flat(j["grads"])}, {"g": _flat(grads)})["g"]
    assert whole <= GLOBAL_GRAD_RTOL, whole


def test_slice_bp_grad_frac_keeps_the_gradient(slice_runs):
    fw, frags, _ = slice_runs
    loss, logs, grads = _port_step(fw, frags)
    for extra in (dict(BP_GRAD_FRAC=0.25),
                  dict(BACKBONE2D=dict(ARC="fpn-mnas-0.5", MODE="batch", INFER_MODE="batch"))):
        other = torch_nr.NeuralRecon(dict(CFG, **extra), device="cpu")
        other.net.load_state_dict(fw.net.state_dict())
        loss_f, logs_f, grads_f = _port_step(other, frags)
        assert loss_f == loss and logs_f == logs, extra
        rel = leaf_rel_errors(grads, grads_f)
        assert max(rel.values()) == 0.0, (extra, max(rel.items(), key=lambda kv: kv[1]))


def _flat(tree):
    return np.concatenate([np.ravel(v) if not isinstance(v, dict) else _flat(v)
                           for _, v in sorted(tree.items())])
