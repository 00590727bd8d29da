"""Whole-slice parity, dense pyramid: forward_test over two fragments with
carried state, and val_fn, JAX vs the port on the CPU in float32.

Tolerance 2e-3 absolute: the back-projection gather table is bf16 on every
path (``bp_gather_dtype`` defaults to bfloat16), and float32 differences of
~1e-6 upstream of it occasionally round a feature to the neighbouring bf16
value (one ulp, ~4e-3 relative), which the 3D UNet and GRU carry on.  Masks
must agree exactly.
"""
import numpy as np
import pytest
import torch

from torch_slice_helpers import build_pair, compare, run_jax, run_torch, two_fragments

torch.set_num_threads(2)

MODEL_CFGS = dict(N_LAYER=3, N_VOX=[24, 24, 24], VOXEL_SIZE=0.08,
                  FUSION=dict(FUSION_ON=True, FULL=True), LW=[1.0, 0.8, 0.64],
                  THRESHOLDS=[0, 0, 0], POS_WEIGHT=1.5,
                  BACKBONE2D=dict(ARC="fpn-mnas-0.5"))


@pytest.fixture(scope="module")
def frags():
    return two_fragments(n_views=4, n_vox=24)


@pytest.fixture(scope="module")
def pair(frags):
    return build_pair(MODEL_CFGS, frags)


# TRAIN_NUM_SAMPLE [64, 256] caps levels 1-2 at 512/2048 voxels: the masked
# (capacity) back-projection branch
@pytest.mark.parametrize("extra", [{}, dict(TRAIN_NUM_SAMPLE=[64, 256])],
                         ids=["dense", "dense_capacity"])
def test_stream_and_val_match_jax(frags, pair, extra):
    import deep3dmap_tpu.models.frameworks.neuralrecon as jax_nr
    import deep3dmap_tpu_torch.models.frameworks.neuralrecon as torch_nr

    jfw, params, tfw = pair
    if extra:
        cfg = dict(MODEL_CFGS, **extra)
        jfw = jax_nr.NeuralRecon(cfg)   # same param tree: reuse the weights
        net = tfw.net
        tfw = torch_nr.NeuralRecon(cfg, device="cpu")
        tfw.net.load_state_dict(net.state_dict())
        assert tfw.num_sample == (None, 512, 2048)
    j = run_jax(jfw, params, frags)
    t = run_torch(tfw, frags)
    for frag in ("o1", "o2"):
        assert t[frag]["tsdf"].shape == (2, 24, 24, 24)
        assert np.isfinite(t[frag]["tsdf"]).all()
    compare(j, t, atol=2e-3, val_rtol=1e-4)
