"""Port parity: ``ops/upfirdn2d.py`` against the JAX package, forward and VJP.

Every function on the same seeded inputs, with a kernel that is not
symmetric (so a missing flip shows), up and down 1 and 2, and the pads the
StyleGAN2 modules use; the VJP against ``jax.vjp`` with a seeded
cotangent.  Tolerance: 1e-5 abs (float32 depthwise sums of <= 16 terms,
summed in another order).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deep3dmap_tpu.ops import upfirdn2d as J
from deep3dmap_tpu_torch.ops import upfirdn2d as T

torch.set_num_threads(2)
ATOL = 1e-5
ASYM = [[1.0, 2.0, 0.5], [0.0, 3.0, 1.0], [2.0, 0.25, 1.5]]   # not symmetric


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _check(jfn, tfn, args, rng, atol=ATOL):
    """Forward and VJP w.r.t. every argument against ``jax.vjp``."""
    jargs = [jnp.asarray(a) for a in args]
    targs = [_t(a).requires_grad_() for a in args]
    jy, jvjp = jax.vjp(jfn, *jargs)
    ty = tfn(*targs)
    assert tuple(ty.shape) == tuple(jy.shape)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=atol, rtol=0)
    g = rng.randn(*jy.shape).astype(np.float32)
    jg = jvjp(jnp.asarray(g))
    tg = torch.autograd.grad(ty, targs, _t(g))
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol, rtol=0)


def test_make_kernel_matches(rng):
    for k in ([1, 3, 3, 1], [1, 2, 1], ASYM):
        np.testing.assert_array_equal(T.make_kernel(k).numpy(),
                                      np.asarray(J.make_kernel(k)))


@pytest.mark.parametrize("up,down,pad", [(1, 1, (1, 1)), (2, 1, (2, 1)),
                                         (1, 2, (1, 0)), (2, 2, (1, 2)),
                                         (1, 1, (0, 0))])
def test_upfirdn2d_matches_jax(rng, up, down, pad):
    x = rng.randn(2, 7, 6, 3).astype(np.float32)
    k = np.asarray(J.make_kernel(ASYM))
    _check(lambda a: J.upfirdn2d(a, jnp.asarray(k), up=up, down=down, pad=pad),
           lambda a: T.upfirdn2d(a, _t(k), up=up, down=down, pad=pad), [x], rng)


def test_kernel_is_convolved_not_correlated(rng):
    """One impulse through the asymmetric kernel comes out as the kernel
    itself (a correlation would give it flipped)."""
    x = np.zeros((1, 5, 5, 1), np.float32)
    x[0, 2, 2, 0] = 1.0
    k = np.asarray(ASYM, np.float32)
    y = T.upfirdn2d(_t(x), _t(k), pad=(1, 1))[0, 1:4, 1:4, 0].numpy()
    np.testing.assert_array_equal(y, k)


@pytest.mark.parametrize("name", ["upsample2d", "downsample2d"])
@pytest.mark.parametrize("taps", [[1, 3, 3, 1], [1, 2, 4, 1]])
def test_resample_matches_jax(rng, name, taps):
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    k = np.asarray(J.make_kernel(taps))
    _check(lambda a: getattr(J, name)(a, jnp.asarray(k)),
           lambda a: getattr(T, name)(a, _t(k)), [x], rng)


@pytest.mark.parametrize("pad", [(2, 2), (1, 1), (2, 1)])
def test_blur2d_matches_jax(rng, pad):
    x = rng.randn(1, 9, 9, 5).astype(np.float32)
    k = np.asarray(J.make_kernel([1, 2, 4, 1])) * 4.0
    _check(lambda a: J.blur2d(a, jnp.asarray(k), pad=pad),
           lambda a: T.blur2d(a, _t(k), pad=pad), [x], rng)


def test_fused_leaky_relu_matches_jax(rng):
    x = rng.randn(2, 4, 4, 6).astype(np.float32)
    x[0, 0, 0, :] = 0.0          # the gradient at 0 is 1, as jax.nn.leaky_relu's
    b = rng.randn(6).astype(np.float32)
    _check(lambda a, c: J.fused_leaky_relu(a, c), T.fused_leaky_relu, [x, b], rng)
    _check(lambda a: J.fused_leaky_relu(a), T.fused_leaky_relu, [x], rng)
    xr = _t(np.zeros((1, 3), np.float32)).requires_grad_()
    (g,) = torch.autograd.grad(T.fused_leaky_relu(xr).sum(), xr)
    np.testing.assert_allclose(g.numpy(), np.full((1, 3), 2 ** 0.5, np.float32))


def test_negative_pad_raises():
    with pytest.raises(ValueError, match="negative pad"):
        T.upfirdn2d(torch.zeros(1, 4, 4, 1), T.make_kernel([1, 1]), pad=(-1, 0))
