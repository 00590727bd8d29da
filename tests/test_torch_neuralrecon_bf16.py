"""Whole-slice parity at the bench dtypes: the block-sparse pyramid with
bf16 hidden volumes (GLOBAL_DTYPE), bf16 block UNet/GRU compute (BLOCK_DTYPE)
and a bf16 2D trunk (BACKBONE2D.DTYPE), as ``bench.py`` configures it, at
the small block size.  forward_test over two fragments with carried state,
and val_fn, JAX vs the port on the CPU.

The block ids must agree exactly.  Values are held to mean and max
tolerances instead of the float32 tests' 2e-3, for this reason: every conv
output and hidden-state write rounds to bf16 (~4e-3 relative), the two
frameworks round GroupNorm statistics and conv sums in different orders, so
some values land on the other side of a bf16 rounding step, and 20-odd
layers then carry those one-ulp steps on.  With random weights the
occupancy logits sit near the threshold 0, so such steps also flip
occupancy bits, which gate the next level's inputs.  Measured on this input:
JAX's own bf16 run differs from its float32 run by occupancy-probability
mean 0.010 / max 0.26 and finest hidden-state mean 0.035 / max 1.2; the
port's bf16 run differs from JAX's bf16 run by less (0.008 / 0.15 and
0.023 / 0.98).  The mean tolerances below sit above the latter and at about
the former: the port may differ from JAX by no more than JAX's own bf16
rounding moves JAX, and the validation loss (a mean over thousands of
voxels) within 1e-4, where the bf16-vs-float32 change moves it by 2e-3.
"""
import numpy as np
import pytest
import torch

from torch_slice_helpers import build_pair, run_jax, run_torch, two_fragments

torch.set_num_threads(2)

BENCH_DTYPES_CFGS = dict(
    N_LAYER=3, N_VOX=[32, 32, 32], VOXEL_SIZE=0.08, TRAIN_NUM_SAMPLE=[64, 256],
    FUSION=dict(FUSION_ON=True, FULL=True), LW=[1.0, 0.8, 0.64],
    THRESHOLDS=[0, 0, 0], POS_WEIGHT=1.5, SPARSE_MODE="block", BLOCK_SIZE=8,
    MAX_BLOCKS=[None, 4, 24], GLOBAL_DTYPE="bfloat16", BLOCK_DTYPE="bfloat16",
    BACKBONE2D=dict(ARC="fpn-mnas-0.5", DTYPE="bfloat16", MODE="batch",
                    INFER_MODE="batch"))

OCC_MEAN, OCC_MAX = 0.01, 0.2           # occupancy probability
TSDF_MEAN = 0.02                        # masked tsdf output, all voxels
HIDDEN_MEAN = (0.007, 0.016, 0.035)     # per level, coarse -> fine
VAL_RTOL = 1e-4


@pytest.fixture(scope="module")
def frags():
    return two_fragments(n_views=3, n_vox=32)


def _diff(a, b):
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    return d.mean(), d.max()


def test_stream_and_val_match_jax_bf16(frags):
    jfw, params, tfw = build_pair(BENCH_DTYPES_CFGS, frags)
    assert all(v.dtype == torch.bfloat16
               for v in tfw.init_state(2)["global_hidden"].volumes)
    j = run_jax(jfw, params, frags)
    t = run_torch(tfw, frags)
    assert len(t["ids"]) == 6
    for a, b in zip(j["ids"], t["ids"]):
        np.testing.assert_array_equal(a, b)
    for frag in ("o1", "o2"):
        assert np.isfinite(t[frag]["tsdf"]).all()
        np.testing.assert_array_equal(j[frag]["origin"], t[frag]["origin"])
        occ_mean, occ_max = _diff(j[frag]["occ"], t[frag]["occ"])
        assert occ_mean < OCC_MEAN and occ_max < OCC_MAX, (frag, occ_mean, occ_max)
        tsdf_mean, _ = _diff(j[frag]["tsdf"], t[frag]["tsdf"])
        assert tsdf_mean < TSDF_MEAN, (frag, tsdf_mean)
    for lvl, (a, b) in enumerate(zip(j["hidden"], t["hidden"])):
        h_mean, _ = _diff(a, b)
        assert h_mean < HIDDEN_MEAN[lvl], (lvl, h_mean)
    np.testing.assert_allclose(float(j["val"]), t["val"], rtol=VAL_RTOL)
