"""Training parity, Gan2Shape: the port against the JAX package on the CPU.

The JAX ``Gan2Shape.init`` trees (heads, generator, discriminator, centres)
and ``PerceptualLoss.params`` carried across by ``load_flax``; a small GAN
(``gan_size`` 16, ``z_dim`` 32, ``n_mlp`` 4, ``F1_d`` 2) under a 32² image,
so both resizes of step 2 run (16 -> 32 after the generator, 32 -> 16
before the discriminator); ``batchsize`` 4.  In both raster modes:
``sample_pseudo_imgs`` with JAX's own ``jax.random`` draws, then
``loss_fn`` of each step, its logs and every head's gradient against
``jax.value_and_grad`` (jitted once per mode).  The generator's
``noise_strength`` leaves are zero at init, so its noise, which each side
draws from its own generator, does not enter (the generator with noise is
``tests/test_torch_stylegan2.py``'s).  The resize, ``gan_ckpt`` and the
runner are ``tests/test_torch_gan2shape_runner.py``'s.

Tolerances, measured and rounded up.  Logs within 5e-5 rel (measured
9.5e-6 on ``loss_latent_norm``, a mean of squared differences; 1.4e-6 on
the rest).  Head gradients within 1e-4 per leaf (``leaf_rel_errors``) in
steps 1 and 2 (measured 3.8e-5).  Step 3 agrees to 8.8e-4 per leaf with the
hard raster and 2.5e-5 with the splat on these inputs, and to 2.7e-3 with
the splat on projected samples of another seed: that step's gradient is
ill-conditioned, not computed by another rule.  The port's own step-3
gradient moves by 8.1e-4 (splat) and 3.2e-5 (hard) per leaf when its input
image is scaled by 1 + 1e-7 (about one float32 ulp), and by 4.2e-3 and
1.0e-3 at 1 + 1e-6: the four projected samples are rendered under the
views the view head predicts for them, so a pixel centre within rounding
of a triangle edge (hard) or of a splat cell's border (splat) moves a
depth, the mask that depth gives and the texture sample behind it, and
VGG's ReLUs pass or block what follows.  Its tolerance is 1e-2.  Pseudo
images within 1e-4 abs (measured 2.4e-5), their masks equal.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deep3dmap_tpu.datasets.gan_faces import SyntheticGanFaceDataset as JDataset
from deep3dmap_tpu.models.frameworks import gan2shape as JG
from deep3dmap_tpu_torch.models.frameworks import gan2shape as TG
from deep3dmap_tpu_torch.runners import gan2shape_runner as TR
from deep3dmap_tpu_torch.utils.from_flax import to_flax_grads
from torch_slice_helpers import leaf_rel_errors

torch.set_num_threads(2)
CFG = dict(image_size=32, gan_size=16, z_dim=32, n_mlp=4, nf=8, batchsize=4,
           channel_multiplier=1, F1_d=2)
HEADS = ("depth_head", "albedo_head", "view_head", "light_head", "encoder_head")
LOG_RTOL = 5e-5
GRAD_RTOL = 1e-4
STEP3_GRAD_RTOL = 1e-2
PSEUDO_ATOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def jax_draws(jfw, rng, b):
    """The draws JAX's ``forward_step2(rng)`` makes for its pseudo images
    (``gan2shape.py:297, 251-268``), as numpy arrays."""
    r1, _ = jax.random.split(rng)
    r = jax.random.split(r1, 4)
    x_min, x_max, y_min, y_max, dmin, dmax, _ = jfw.rand_light
    u = jax.random.uniform
    return r1, dict(
        dxy=np.stack([np.asarray(u(r[0], (b,), minval=x_min, maxval=x_max)),
                      np.asarray(u(r[1], (b,), minval=y_min, maxval=y_max))], -1),
        rand=np.asarray(u(r[2], (b, 1, 1, 1), minval=dmin, maxval=dmax)),
        views=np.asarray(u(r[3], (b, 6), minval=-1.0, maxval=1.0)))


@pytest.fixture(scope="module")
def jax_init():
    jfw = JG.Gan2Shape(CFG)
    batch = JDataset(n_samples=1, image_size=32, z_dim=32).setup_input(0)
    params, mstate = jfw.init(jax.random.PRNGKey(0), batch)
    return _np(params), _np(mstate), _np(jfw.perceptual.params), batch


def _canon(jfw, params, mstate, batch):
    """The runner's snapshot of the canonical estimate, from the JAX side."""
    out, _ = jfw.forward_test(params, mstate, batch)
    light = jfw.light_head.apply({"params": params["light_head"]}, batch["input_im"])
    return {k: np.asarray(v) for k, v in dict(
        depth=out["depth"], albedo=out["albedo"], normal=out["normal"],
        light=light).items()}


@pytest.fixture(scope="module", params=["splat", "hard"])
def pair(request, jax_init):
    """Both frameworks in one raster mode, each step's value and gradient
    on both sides, and the inputs they were given."""
    params, mstate, perc, batch = jax_init
    cfg = dict(CFG, raster_mode=request.param)
    jfw = JG.Gan2Shape(cfg)
    jfw.perceptual.params = jax.tree_util.tree_map(jnp.asarray, perc)
    tfw = TG.Gan2Shape(cfg, device="cpu")
    net = tfw.load_flax(params, perc, mstate)
    state = tfw.gan_state()

    rng = jax.random.PRNGKey(7)
    r1, draws = jax_draws(jfw, rng, CFG["batchsize"])
    b2 = dict(batch, **_canon(jfw, params, mstate, batch))
    _, _, o2 = tfw.forward_step2(net, state, b2, draws={k: _t(v) for k, v in draws.items()})
    b3 = dict(batch, proj_im=o2["proj_im"].numpy(), proj_mask=o2["mask"].numpy())
    inputs = dict(step1=(batch, None), step2=(b2, draws), step3=(b3, None))

    res = {}
    for mode, (b, dr) in inputs.items():
        f = jax.jit(jax.value_and_grad(
            lambda p, m, bb, k, mode=mode: jfw.loss_fn(p, m, bb, k, mode=mode),
            has_aux=True))
        (jl, jaux), jg = f(params, mstate, b, rng)
        net.zero_grad(set_to_none=True)
        tl, taux = tfw.loss_fn(net, state, b, None, mode=mode,
                               draws=None if dr is None else {k: _t(v) for k, v in dr.items()})
        tl.backward()
        res[mode] = dict(
            jax=(float(jl), {k: float(v) for k, v in jaux["log_vars"].items()}, _np(jg)),
            torch=(float(tl.detach()), {k: float(v.detach()) for k, v in taux["log_vars"].items()},
                   to_flax_grads(net)),
            aux=taux)
    return dict(mode=request.param, jfw=jfw, tfw=tfw, net=net, state=state,
                r1=r1, draws=draws, b2=b2, res=res)


def test_sample_pseudo_imgs_matches_jax(pair):
    jfw, tfw, b2 = pair["jfw"], pair["tfw"], pair["b2"]
    canon = {k: b2[k] for k in ("depth", "albedo", "normal", "light")}
    jim, jmask = jfw.sample_pseudo_imgs(pair["r1"], {k: jnp.asarray(v) for k, v in canon.items()},
                                        CFG["batchsize"])
    tim, tmask = tfw.sample_pseudo_imgs(None, {k: _t(v) for k, v in canon.items()},
                                        CFG["batchsize"],
                                        draws={k: _t(v) for k, v in pair["draws"].items()})
    assert tuple(tim.shape) == (4, 32, 32, 3) and tuple(tmask.shape) == (4, 32, 32, 1)
    np.testing.assert_allclose(tim.numpy(), np.asarray(jim), atol=PSEUDO_ATOL, rtol=0)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    # the draws from a generator are in JAX's ranges
    d = tfw.pseudo_draws(torch.Generator().manual_seed(0), 256)
    x_min, x_max, y_min, y_max, dmin, dmax, _ = tfw.rand_light
    for v, lo, hi in ((d["dxy"][:, 0], x_min, x_max), (d["dxy"][:, 1], y_min, y_max),
                      (d["rand"], dmin, dmax), (d["views"], -1.0, 1.0)):
        assert lo <= float(v.min()) and float(v.max()) <= hi
        assert float(v.max()) - float(v.min()) > 0.9 * (hi - lo)


@pytest.mark.parametrize("step", ["step1", "step2", "step3"])
def test_step_loss_logs_and_head_grads_match_jax(pair, step):
    (jl, jlog, jg), (tl, tlog, tg) = pair["res"][step]["jax"], pair["res"][step]["torch"]
    np.testing.assert_allclose(tl, jl, rtol=LOG_RTOL)
    assert set(tlog) == set(jlog)
    for k in jlog:
        np.testing.assert_allclose(tlog[k], jlog[k], rtol=LOG_RTOL, err_msg=k)
    tol = STEP3_GRAD_RTOL if step == "step3" else GRAD_RTOL
    errs = leaf_rel_errors(jg, tg)
    assert max(errs.values()) <= tol, {k: v for k, v in errs.items() if v > tol}
    trained = set(TR.MODE_NETS[step])
    for h in HEADS:      # the heads a step does not reach get no gradient
        norm = sum(float(np.abs(a).sum()) for a in jax.tree_util.tree_leaves(tg[h]))
        assert (norm > 0) == (h in trained), (h, norm)


def test_step_outputs_and_mode(pair):
    tfw, net, state = pair["tfw"], pair["net"], pair["state"]
    aux = pair["res"]["step1"]["aux"]
    assert aux["model_state"] is state and net.training
    _, _, out = tfw.forward_step2(net, state, pair["b2"],
                                  draws={k: _t(v) for k, v in pair["draws"].items()})
    assert tuple(out["proj_im"].shape) == (4, 32, 32, 3)
    assert not out["proj_im"].requires_grad
    assert float(out["proj_im"].abs().max()) <= 1.0
    tfw.set_mode("step2")
    a, _ = tfw.loss_fn(net, state, pair["b2"], None,
                       draws={k: _t(v) for k, v in pair["draws"].items()})
    np.testing.assert_allclose(float(a.detach()), pair["res"]["step2"]["torch"][0],
                               rtol=1e-6)
    tfw.set_mode("step1")
    with pytest.raises(ValueError):
        tfw.set_mode("step4")
