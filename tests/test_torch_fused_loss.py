"""Port parity: the fused TSDF/occupancy loss.

The plain PyTorch version (what the wrapper runs for CPU tensors) is held
against the JAX Pallas kernel in interpret mode and against the jnp path of
``NeuralRecon.compute_level_loss``, on the cases of tests/test_pallas_loss.py.
The backward (``fused_tsdf_occ_loss_bwd_plain``, and the autograd Function
that routes CPU tensors to it) is held against ``jax.vjp`` of the Pallas
kernel's custom VJP (``_bwd``) in interpret mode.  The Triton kernels
themselves run only on a GPU: their test is
``tests/test_torch_fused_loss_cuda.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deep3dmap_tpu.models.frameworks.neuralrecon import NeuralRecon as JaxNeuralRecon
from deep3dmap_tpu.ops.pallas_loss import fused_tsdf_occ_loss as jax_fused
from deep3dmap_tpu_torch.ops import fused_loss

RTOL = 1e-5  # fp32 sums over <= 3456 elements, different summation order
# backward, f32: elementwise, the same ops; sigmoid and log differ by an ulp
GRAD_TOL = dict(rtol=1e-5, atol=1e-10)
# backward into bf16 predictions: an ulp of f32 may round to the next bf16
GRAD_TOL_BF16 = dict(rtol=2 ** -7, atol=1e-10)


def _jnp_path(tsdf, occ, tsdf_t, occ_t, mask, pos_weight):
    fw = JaxNeuralRecon.__new__(JaxNeuralRecon)
    fw.pos_weight = pos_weight
    fw.use_pallas_loss = False
    return fw.compute_level_loss(jnp.asarray(tsdf)[..., None],
                                 jnp.asarray(occ)[..., None],
                                 jnp.asarray(tsdf_t), jnp.asarray(occ_t),
                                 jnp.asarray(mask))


def _data(rng, shape=(2, 12, 12, 12)):
    tsdf = rng.uniform(-1, 1, shape).astype(np.float32)
    occ = rng.randn(*shape).astype(np.float32)
    tsdf_t = rng.uniform(-1, 1, shape).astype(np.float32)
    occ_t = (rng.rand(*shape) > 0.7).astype(np.float32)
    mask = (rng.rand(*shape) > 0.3).astype(np.float32)
    return tsdf, occ, tsdf_t, occ_t, mask


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _check(got, want, rtol=RTOL, atol=0.0):
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=rtol, atol=atol)


@pytest.mark.parametrize("pos_weight", [1.0, 1.5])
def test_plain_matches_jax_kernel_and_jnp(rng, pos_weight):
    data = _data(rng)
    got = fused_loss.fused_tsdf_occ_loss_plain(*_torch(*data), pos_weight=pos_weight)
    kern = jax_fused(*(jnp.asarray(a) for a in data), pos_weight, True)
    _check(got, kern)
    _check(got, _jnp_path(*data, pos_weight))


def test_plain_empty_target(rng):
    tsdf, occ, tsdf_t, _, mask = _data(rng)
    occ_t = np.zeros_like(tsdf_t)
    total, occ_l, tsdf_l = fused_loss.fused_tsdf_occ_loss_plain(
        *_torch(tsdf, occ, tsdf_t, occ_t, mask), pos_weight=1.5)
    assert float(total) == 0.0  # no positive voxels -> zero loss (reference)
    kern = jax_fused(*(jnp.asarray(a) for a in (tsdf, occ, tsdf_t, occ_t, mask)),
                     1.5, True)
    _check((total, occ_l, tsdf_l), kern)


def test_plain_nonaligned_size(rng):
    # 1000 elements: not a multiple of the JAX kernel's 2048-element block
    shape = (10, 10, 10)
    tsdf, occ, tsdf_t, occ_t, _ = (rng.rand(*shape).astype(np.float32)
                                   for _ in range(5))
    occ_t = (occ_t > 0.5).astype(np.float32)
    mask = np.ones(shape, np.float32)
    data = (tsdf, occ, tsdf_t, occ_t, mask)
    got = fused_loss.fused_tsdf_occ_loss_plain(*_torch(*data), pos_weight=1.0)
    _check(got, jax_fused(*(jnp.asarray(a) for a in data), 1.0, True))
    _check(got, _jnp_path(*data, 1.0))


def test_plain_bf16_predictions_bool_masks(rng):
    """bf16 predictions and bool targets/mask, read in their own dtypes; the
    reference gets the same (bf16-rounded) values in f32."""
    tsdf, occ, tsdf_t, occ_t, mask = _data(rng)
    t_bf = torch.from_numpy(tsdf).bfloat16()
    o_bf = torch.from_numpy(occ).bfloat16()
    got = fused_loss.fused_tsdf_occ_loss_plain(
        t_bf, o_bf, torch.from_numpy(tsdf_t), torch.from_numpy(occ_t > 0.5),
        torch.from_numpy(mask > 0.5), pos_weight=1.5)
    ref = (t_bf.float().numpy(), o_bf.float().numpy(), tsdf_t, occ_t, mask)
    _check(got, jax_fused(*(jnp.asarray(a) for a in ref), 1.5, True))


def test_wrapper_routes_cpu_tensors_to_plain(rng):
    """CPU tensors take the plain version and launch nothing; mixed devices
    and mismatched shapes raise."""
    data = _torch(*_data(rng))
    before = fused_loss.launches
    got = fused_loss.fused_tsdf_occ_loss(*data, pos_weight=1.5)
    _check(got, fused_loss.fused_tsdf_occ_loss_plain(*data, pos_weight=1.5),
           rtol=0.0)
    assert fused_loss.launches == before
    with pytest.raises(ValueError, match="shapes differ"):
        fused_loss.fused_tsdf_occ_loss(data[0][:1], *data[1:])
    meta = tuple(a.to("meta") for a in data)
    with pytest.raises(ValueError, match="CUDA device"):
        fused_loss.fused_tsdf_occ_loss(*meta)


def _jax_vjp(data, pos_weight, g):
    """(d_tsdf, d_occ) of the Pallas kernel's custom VJP in interpret mode
    under the cotangents g = (g_total, g_occ, g_tsdf)."""
    t, x, *rest = (jnp.asarray(a) for a in data)
    _, vjp = jax.vjp(lambda a, b: jax_fused(a, b, *rest, pos_weight, True), t, x)
    return [np.asarray(v, np.float32) for v in vjp(tuple(jnp.float32(v) for v in g))]


def _torch_vjp(data, pos_weight, g):
    t, x, *rest = _torch(*data)
    t.requires_grad_()
    x.requires_grad_()
    before = (fused_loss.launches, fused_loss.bwd_launches)
    out = fused_loss.fused_tsdf_occ_loss(t, x, *rest, pos_weight=pos_weight)
    grads = torch.autograd.grad(out, (t, x), [torch.tensor(v) for v in g])
    assert (fused_loss.launches, fused_loss.bwd_launches) == before
    return [a.float().numpy() for a in grads]


def _check_grads(got, want, tol=GRAD_TOL):
    assert any(np.abs(b).max() > 0 for b in want)
    for name, a, b in zip(("d_tsdf", "d_occ"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **tol)


@pytest.mark.parametrize("g", [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
                               (0.7, -0.3, 2.0)],
                         ids=["g_total", "g_occ", "g_tsdf", "all"])
@pytest.mark.parametrize("pos_weight", [1.0, 1.5])
def test_backward_matches_jax_custom_vjp(rng, g, pos_weight):
    """Each cotangent alone and all three: the autograd Function on CPU
    tensors (the plain backward) against JAX's ``_bwd``."""
    data = _data(rng)
    _check_grads(_torch_vjp(data, pos_weight, g), _jax_vjp(data, pos_weight, g))


def test_backward_matches_jnp_autodiff(rng):
    """Away from tsdf == 0, ``_bwd`` is the jnp loss's own gradient (the
    path JAX's ``loss_fn`` differentiates off the TPU)."""
    data = _data(rng)
    want = jax.grad(lambda t, x: _jnp_path(t, x, *data[2:], 1.5)[0],
                    argnums=(0, 1))(jnp.asarray(data[0]), jnp.asarray(data[1]))
    _check_grads(_torch_vjp(data, 1.5, (1.0, 0.0, 0.0)),
                 [np.asarray(w) for w in want], dict(rtol=1e-4, atol=1e-9))


def test_backward_empty_target(rng):
    """No positive voxel: total is 0 and w1 = 0, so only the occupancy
    gradient through g_occ remains."""
    tsdf, occ, tsdf_t, _, mask = _data(rng)
    data = (tsdf, occ, tsdf_t, np.zeros_like(tsdf_t), mask)
    g = (1.0, 0.5, 0.25)
    got = _torch_vjp(data, 1.5, g)
    assert not got[0].any()          # m·y = 0 everywhere
    want = _jax_vjp(data, 1.5, g)
    np.testing.assert_array_equal(want[0], 0.0)
    np.testing.assert_allclose(got[1], want[1], **GRAD_TOL)


def test_backward_nonaligned_size(rng):
    shape = (10, 10, 10)     # not a multiple of the JAX kernel's block
    data = _data(rng, shape)
    _check_grads(_torch_vjp(data, 1.0, (1.0, 0.2, 0.3)),
                 _jax_vjp(data, 1.0, (1.0, 0.2, 0.3)))


def test_backward_bf16_predictions(rng):
    """bf16 predictions get bf16 gradients, as ``_bwd`` casts them."""
    tsdf, occ, tsdf_t, occ_t, mask = _data(rng)
    t_bf = torch.from_numpy(tsdf).bfloat16().requires_grad_()
    x_bf = torch.from_numpy(occ).bfloat16().requires_grad_()
    out = fused_loss.fused_tsdf_occ_loss(t_bf, x_bf, *_torch(tsdf_t, occ_t, mask),
                                         pos_weight=1.5)
    got = torch.autograd.grad(out[0], (t_bf, x_bf))
    assert all(a.dtype == torch.bfloat16 for a in got)
    t_j = jnp.asarray(t_bf.detach().float().numpy()).astype(jnp.bfloat16)
    x_j = jnp.asarray(x_bf.detach().float().numpy()).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b: jax_fused(a, b, jnp.asarray(tsdf_t),
                                            jnp.asarray(occ_t), jnp.asarray(mask),
                                            1.5, True), t_j, x_j)
    want = vjp((jnp.float32(1), jnp.float32(0), jnp.float32(0)))
    assert all(w.dtype == jnp.bfloat16 for w in want)
    _check_grads([a.float().numpy() for a in got],
                 [np.asarray(w, np.float32) for w in want], GRAD_TOL_BF16)


def test_backward_pins_bwd_rule_at_zero_tsdf(rng):
    """At t == 0 exactly, ``_bwd`` gives sign(lt − ltt)/n_p where autodiff of
    the jnp loss gives 0 (sign'(0) = 0); the port follows ``_bwd``, which is
    what the TPU computes."""
    tsdf, occ, tsdf_t, occ_t, mask = _data(rng)
    zero = (occ_t * mask > 0) & (rng.rand(*tsdf.shape) < 0.3)
    assert zero.sum() > 10
    tsdf = np.where(zero, np.float32(0), tsdf)
    data = (tsdf, occ, tsdf_t, occ_t, mask)
    got = _torch_vjp(data, 1.5, (1.0, 0.0, 0.0))
    _check_grads(got, _jax_vjp(data, 1.5, (1.0, 0.0, 0.0)))
    n_p = float((occ_t * mask).sum())
    np.testing.assert_allclose(got[0][zero], -np.sign(tsdf_t[zero]) / n_p, rtol=1e-6)
    autodiff = jax.grad(lambda t: _jnp_path(t, occ, tsdf_t, occ_t, mask, 1.5)[0])(
        jnp.asarray(tsdf))
    np.testing.assert_array_equal(np.asarray(autodiff)[zero], 0.0)


def test_plain_backward_direct(rng):
    """``fused_tsdf_occ_loss_bwd_plain`` called as chip_smoke.py calls it:
    the forward's sums and a (3,) cotangent vector."""
    data = _torch(*_data(rng))
    sums = fused_loss.partial_sums_plain(*data)[:2]
    g = torch.tensor([0.7, -0.3, 2.0])
    got = fused_loss.fused_tsdf_occ_loss_bwd_plain(*data, sums, g, pos_weight=1.5)
    _check_grads([a.numpy() for a in got],
                 _jax_vjp([a.numpy() for a in data], 1.5, (0.7, -0.3, 2.0)))
