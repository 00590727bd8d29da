"""Whole-slice parity, block-sparse pyramid (SPARSE_MODE="block"):
forward_test over two fragments with carried state, and val_fn, JAX vs the
port on the CPU in float32, with identical block ids at every block level.

Tolerance 2e-3 absolute, for the reason stated in
test_torch_neuralrecon_dense.py: the bf16 back-projection gather table turns
~1e-6 float32 differences into occasional one-ulp bf16 steps.
"""
import numpy as np
import pytest
import torch

from torch_slice_helpers import build_pair, compare, run_jax, run_torch, two_fragments

torch.set_num_threads(2)

BLOCK_CFGS = dict(N_LAYER=3, N_VOX=[32, 32, 32], VOXEL_SIZE=0.08,
                  TRAIN_NUM_SAMPLE=[64, 256],
                  FUSION=dict(FUSION_ON=True, FULL=True), LW=[1.0, 0.8, 0.64],
                  THRESHOLDS=[0, 0, 0], POS_WEIGHT=1.5,
                  BACKBONE2D=dict(ARC="fpn-mnas-0.5"), SPARSE_MODE="block",
                  BLOCK_SIZE=8, MAX_BLOCKS=[None, 4, 24])


@pytest.fixture(scope="module")
def frags():
    return two_fragments(n_views=3, n_vox=32)


def test_stream_and_val_match_jax(frags):
    jfw, params, tfw = build_pair(BLOCK_CFGS, frags)
    j = run_jax(jfw, params, frags)
    t = run_torch(tfw, frags)
    # 2 block levels x (2 forward_test + 1 val_fn)
    assert len(t["ids"]) == 6
    for frag in ("o1", "o2"):
        assert t[frag]["tsdf"].shape == (2, 32, 32, 32)
        assert np.isfinite(t[frag]["tsdf"]).all()
    compare(j, t, atol=2e-3, val_rtol=1e-4)
