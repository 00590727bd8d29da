"""Port parity: the conv stacks, the GRUs, the 2D trunk and the global volume,
each against its flax twin with weights carried over by ``from_flax``; and
the weight converter itself.

Tolerance for the conv stacks: 1e-4 absolute in float32 -- the two
frameworks sum a conv's products in different orders, and several convs and
GroupNorms compound it.  Pure data movement (global-volume windows) agrees
exactly.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deep3dmap_tpu.models.backbones.fpn2d import MnasFPN as JMnasFPN
from deep3dmap_tpu.models.modulars import block_dense3d as JB
from deep3dmap_tpu.models.modulars import global_volume as JG
from deep3dmap_tpu.models.modulars.conv_gru3d import ConvGRU3D as JConvGRU3D
from deep3dmap_tpu.models.modulars.dense3d import UNet3D as JUNet3D
from deep3dmap_tpu.ops.block_sparse import select_blocks as jselect
from deep3dmap_tpu_torch.models.backbones.fpn2d import MnasFPN
from deep3dmap_tpu_torch.models.modulars import block_dense3d as TB
from deep3dmap_tpu_torch.models.modulars import global_volume as TG
from deep3dmap_tpu_torch.models.modulars.conv_gru3d import ConvGRU3D
from deep3dmap_tpu_torch.models.modulars.dense3d import UNet3D
from deep3dmap_tpu_torch.ops.block_sparse import select_blocks as tselect
from deep3dmap_tpu_torch.utils.from_flax import load_flax_params, to_flax_params

torch.set_num_threads(2)
ATOL = 1e-4


def _init(jmod, *args):
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map(np.asarray, params)


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.detach().float().numpy(), atol=atol, rtol=0)


def test_unet3d_odd_side(rng):
    """6³: stride-2 SAME pads (0,1) at 6 and (1,1) at 3; the 2³ -> 4³
    upsample is cropped back to 3³."""
    x = rng.randn(2, 6, 6, 6, 10).astype(np.float32)
    jm = JUNet3D(16, cr=0.5)
    p = _init(jm, jnp.asarray(x))
    tm = load_flax_params(UNet3D(10, 16, cr=0.5), p)
    _close(jm.apply(p, jnp.asarray(x)), tm(torch.from_numpy(x)))


def test_conv_gru3d_promotes_bf16_hidden(rng):
    """A bf16 hidden window meets an fp32 x: the cell computes in fp32."""
    h = rng.randn(1, 8, 8, 8, 8).astype(np.float32)
    x = rng.randn(1, 8, 8, 8, 8).astype(np.float32)
    hb = jnp.asarray(h).astype(jnp.bfloat16)
    jm = JConvGRU3D(8)
    p = _init(jm, hb, jnp.asarray(x))
    tm = load_flax_params(ConvGRU3D(8, 8), p)
    want = jm.apply(p, hb, jnp.asarray(x))
    got = tm(torch.from_numpy(h).bfloat16(), torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(want, got)


def _bsets(rng, B=2, nb=2, maxb=6):
    m = rng.rand(B, nb, nb, nb) < 0.5
    return jselect(jnp.asarray(m), maxb, 8), tselect(torch.from_numpy(m), maxb, 8)


def test_block_unet3d(rng):
    jset, tset = _bsets(rng)
    x = rng.randn(2, 6, 8, 8, 8, 7).astype(np.float32)
    jm = JB.BlockUNet3D(12, cr=0.5)
    p = _init(jm, jnp.asarray(x), jset)
    tm = load_flax_params(TB.BlockUNet3D(7, 12, cr=0.5), p)
    _close(jm.apply(p, jnp.asarray(x), jset), tm(torch.from_numpy(x), tset))


def test_block_conv_gru3d(rng):
    jset, tset = _bsets(rng)
    h = rng.randn(2, 6, 8, 8, 8, 8).astype(np.float32)
    x = rng.randn(2, 6, 8, 8, 8, 8).astype(np.float32)
    jm = JB.BlockConvGRU3D(8)
    p = _init(jm, jnp.asarray(h), jnp.asarray(x), jset)
    tm = load_flax_params(TB.BlockConvGRU3D(8, 8), p)
    _close(jm.apply(p, jnp.asarray(h), jnp.asarray(x), jset),
           tm(torch.from_numpy(h), torch.from_numpy(x), tset))


@pytest.mark.parametrize("norm,torch_pad", [("gn", False), ("none", True)])
def test_mnas_fpn(rng, norm, torch_pad):
    """Default mode (asymmetric SAME at stride 2, eps-1e-6 GroupNorm) and the
    torch-import mode (bias convs, symmetric padding)."""
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    jm = JMnasFPN(alpha=0.5, norm=norm, torch_pad=torch_pad)
    p = _init(jm, jnp.asarray(x))
    tm = load_flax_params(MnasFPN(alpha=0.5, norm=norm, torch_pad=torch_pad), p)
    for jf, tf in zip(jm.apply(p, jnp.asarray(x)), tm(torch.from_numpy(x))):
        _close(jf, tf)


def test_global_volume_windows(rng):
    """Rounded (half to even) and clamped window starts, the G == window
    identity, and the masked reset."""
    vol = rng.randn(3, 10, 10, 10, 2).astype(np.float32)
    rel = np.array([[2.5, 0.4, 7.6], [-3.0, 4.5, 1.5], [9.0, 3.0, 0.0]],
                   np.float32)
    jr = JG.read_windows_batch(jnp.asarray(vol), jnp.asarray(rel), 4)
    tr = TG.read_windows_batch(torch.from_numpy(vol), torch.from_numpy(rel), 4)
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    data = rng.randn(3, 4, 4, 4, 2).astype(np.float32)
    jw = JG.write_windows_batch(jnp.asarray(vol).astype(jnp.bfloat16),
                                jnp.asarray(data), jnp.asarray(rel))
    tw = TG.write_windows_batch(torch.from_numpy(vol).bfloat16(),
                                torch.from_numpy(data), torch.from_numpy(rel))
    np.testing.assert_array_equal(np.asarray(jw, np.float32), tw.float().numpy())
    full = torch.from_numpy(vol)
    assert TG.read_windows_batch(full, torch.from_numpy(rel), 10) is full
    reset = np.array([True, False, True])
    jst = JG.reset_volumes(JG.GlobalVolumeState((jnp.asarray(vol),)),
                           jnp.asarray(reset))
    tst = TG.reset_volumes(TG.GlobalVolumeState((full,)), torch.from_numpy(reset))
    np.testing.assert_array_equal(np.asarray(jst.volumes[0]),
                                  tst.volumes[0].numpy())


def test_from_flax_roundtrip_and_rejects(rng):
    x = rng.rand(1, 32, 32, 3).astype(np.float32)
    p = _init(JMnasFPN(alpha=0.5), jnp.asarray(x))
    tm = load_flax_params(MnasFPN(alpha=0.5), p)
    back = to_flax_params(tm)
    want = jax.tree_util.tree_leaves_with_path(p["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(want) == len(got)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf)

    missing = jax.tree_util.tree_map(lambda a: a, p)
    del missing["params"]["Conv_7"]
    with pytest.raises(ValueError, match="no flax leaf"):
        load_flax_params(MnasFPN(alpha=0.5), missing)
    extra = jax.tree_util.tree_map(lambda a: a, p)
    extra["params"]["Conv_99"] = {"kernel": np.zeros((1, 1, 2, 2), np.float32)}
    with pytest.raises(ValueError, match="no torch param"):
        load_flax_params(MnasFPN(alpha=0.5), extra)
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(MnasFPN(alpha=1.0), p)
