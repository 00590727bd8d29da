"""Port parity: the fused TSDF/occupancy loss.

The plain PyTorch version (what the wrapper runs for CPU tensors) is held
against the JAX Pallas kernel in interpret mode and against the jnp path of
``NeuralRecon.compute_level_loss``, on the cases of tests/test_pallas_loss.py
(the gradient case waits for the training slice).  The Triton kernel itself
runs only on a GPU: its test is ``tests/test_torch_fused_loss_cuda.py``.
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
