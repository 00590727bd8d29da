"""Port parity of the backward: every module on NeuralRecon's training path,
its input and parameter gradients against ``jax.vjp`` of its flax or JAX
twin, on the same inputs, weights and cotangents (float32 on the CPU).

The port's backward is autograd's; this holds each module's rule, away from
the whole slice's sensitivity to its forward (test_torch_neuralrecon_train.py).
Tolerances: data movement (block gathers and scatters, the halo, the octant
gather, the float32 back-projection) agrees exactly or to float32 rounding
of a sum of a few terms (1e-6 relative); conv stacks to GRAD_RTOL, their
sums taken in another order.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deep3dmap_tpu.models.backbones.fpn2d import MnasFPN as JMnasFPN
from deep3dmap_tpu.models.modulars import block_dense3d as JB
from deep3dmap_tpu.models.modulars.conv_gru3d import ConvGRU3D as JConvGRU3D
from deep3dmap_tpu.models.modulars.dense3d import UNet3D as JUNet3D
from deep3dmap_tpu.ops import block_sparse as JS
from deep3dmap_tpu_torch.models.backbones.fpn2d import MnasFPN
from deep3dmap_tpu_torch.models.modulars import block_dense3d as TB
from deep3dmap_tpu_torch.models.modulars.conv_gru3d import ConvGRU3D
from deep3dmap_tpu_torch.models.modulars.dense3d import UNet3D
from deep3dmap_tpu_torch.ops import block_sparse as TS
from deep3dmap_tpu_torch.utils.from_flax import load_flax_params, to_flax_grads
from torch_slice_helpers import leaf_rel_errors

torch.set_num_threads(2)
GRAD_RTOL = 2e-5
MOVE_RTOL = 1e-6


def _rel(want, got):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want)


def _module_grads(jm, tm, args, rng, bsets=None):
    """jax.vjp and torch autograd of ``module(*args)`` (``module(*args,
    bset)`` for a block module, ``bsets`` = (JAX set, port set)) under one
    random cotangent: (input-grad rel errors, per-leaf param-grad rel
    errors)."""
    jextra, textra = ((bsets[0],), (bsets[1],)) if bsets else ((), ())
    jargs = tuple(jnp.asarray(a) for a in args)

    def apply(p, *xs):
        return jm.apply(p, *xs, *jextra)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda *xs: jm.init(jax.random.PRNGKey(0), *xs, *jextra))(*jargs))
    load_flax_params(tm, params)
    out = jax.jit(apply)(params, *jargs)
    listed = isinstance(out, (tuple, list))
    outs = tuple(out) if listed else (out,)
    cots = tuple(rng.randn(*o.shape).astype(np.float32) for o in outs)
    gp, *gx = jax.jit(lambda p, c, *xs: jax.vjp(apply, p, *xs)[1](c))(
        params, type(out)(cots) if listed else cots[0], *jargs)
    xs = [torch.tensor(a, requires_grad=True) for a in args]
    touts = tm(*xs, *textra)
    touts = touts if isinstance(touts, (tuple, list)) else (touts,)
    torch.autograd.backward(list(touts), [torch.from_numpy(c) for c in cots])
    in_rel = [_rel(g, x.grad.numpy()) for g, x in zip(gx, xs)]
    return in_rel, leaf_rel_errors(jax.tree_util.tree_map(np.asarray, gp)["params"],
                                   to_flax_grads(tm))


def _check(in_rel, p_rel, tol=GRAD_RTOL):
    assert max(in_rel) <= tol, in_rel
    bad = {k: v for k, v in p_rel.items() if v > tol}
    assert not bad, bad


def test_unet3d_grads(rng):
    x = rng.randn(1, 8, 8, 8, 20).astype(np.float32)
    x *= rng.rand(1, 8, 8, 8, 1) > 0.5          # a sparse-masked input
    _check(*_module_grads(JUNet3D(16, cr=0.5), UNet3D(20, 16, cr=0.5), (x,), rng))


def test_conv_gru3d_grads(rng):
    h = rng.randn(1, 6, 6, 6, 8).astype(np.float32)
    x = rng.randn(1, 6, 6, 6, 8).astype(np.float32)
    _check(*_module_grads(JConvGRU3D(8), ConvGRU3D(8, 8), (h, x), rng))


def test_mnas_fpn_grads(rng):
    # 64²: at 32² the stride-32 map is 1x1 and its GroupNorm's variance over
    # a few values is ill-conditioned (the input gradients then differ by 6%)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    _check(*_module_grads(JMnasFPN(alpha=0.5), MnasFPN(alpha=0.5), (x,), rng))


def _bsets(rng, nb=2, maxb=6, bs=8):
    m = rng.rand(2, nb, nb, nb) < 0.5
    m[1, 0, 0, 0] = False
    return JS.select_blocks(jnp.asarray(m), maxb, bs), TS.select_blocks(
        torch.from_numpy(m), maxb, bs)


def test_block_unet3d_grads(rng):
    sets = _bsets(rng)
    x = rng.randn(2, 6, 8, 8, 8, 7).astype(np.float32)
    _check(*_module_grads(JB.BlockUNet3D(12, cr=0.5), TB.BlockUNet3D(7, 12, cr=0.5),
                          (x,), rng, sets))


def test_block_conv_gru3d_grads(rng):
    sets = _bsets(rng)
    h = rng.randn(2, 6, 8, 8, 8, 8).astype(np.float32)
    x = rng.randn(2, 6, 8, 8, 8, 8).astype(np.float32)
    _check(*_module_grads(JB.BlockConvGRU3D(8), TB.BlockConvGRU3D(8, 8), (h, x),
                          rng, sets))


def _vjp_pair(jf, tf, args, rng):
    """Input grads of a parameter-free function, JAX vs the port."""
    jargs = tuple(jnp.asarray(a) for a in args)
    out = jax.jit(jf)(*jargs)
    cot = rng.randn(*out.shape).astype(np.float32)
    gj = jax.jit(lambda c, *xs: jax.vjp(jf, *xs)[1](c))(jnp.asarray(cot), *jargs)
    xs = [torch.tensor(a, requires_grad=True) for a in args]
    (tf(*xs) * torch.from_numpy(cot)).sum().backward()
    return [(np.asarray(g), x.grad.numpy()) for g, x in zip(gj, xs)]


@pytest.mark.parametrize("op", ["dense_to_blocks", "blocks_to_dense",
                                "blocks_to_dense_over", "gather_halo",
                                "gather_parent_octants"])
def test_block_moves_grads(rng, op):
    jset, tset = _bsets(rng, nb=4, maxb=20)
    C = 5
    if op == "dense_to_blocks":
        args = (rng.randn(2, 32, 32, 32, C).astype(np.float32),)
        fns = (lambda v: JS.dense_to_blocks(v, jset),
               lambda v: TS.dense_to_blocks(v, tset))
    elif op == "blocks_to_dense":
        args = (rng.randn(2, 20, 8, 8, 8, C).astype(np.float32),)
        fns = (lambda b: JS.blocks_to_dense(b, jset, fill=1.0),
               lambda b: TS.blocks_to_dense(b, tset, fill=1.0))
    elif op == "blocks_to_dense_over":
        args = (rng.randn(2, 20, 8, 8, 8, C).astype(np.float32),
                rng.randn(2, 32, 32, 32, C).astype(np.float32))
        fns = (lambda b, v: JS.blocks_to_dense_over(b, jset, v),
               lambda b, v: TS.blocks_to_dense_over(b, tset, v))
    elif op == "gather_halo":
        args = (rng.randn(2, 20, 8, 8, 8, C).astype(np.float32),)
        fns = (lambda b: JS.gather_halo(b, jset, 1),
               lambda b: TS.gather_halo(b, tset, 1))
    else:
        pj, pt = _bsets(rng, nb=2, maxb=6)
        m = np.zeros((2, 4, 4, 4), bool)
        m[:, :2, :2] = True
        cj, ct = (JS.select_blocks(jnp.asarray(m), 20, 8),
                  TS.select_blocks(torch.from_numpy(m), 20, 8))
        args = (rng.randn(2, 6, 8, 8, 8, C).astype(np.float32),)
        fns = (lambda b: JS.gather_parent_octants(b, pj, cj, fill=0.5),
               lambda b: TS.gather_parent_octants(b, pt, ct, fill=0.5))
    for gj, gt in _vjp_pair(*fns, args, rng):
        assert np.abs(gj).max() > 0
        np.testing.assert_allclose(gt, gj, rtol=MOVE_RTOL, atol=1e-6)
