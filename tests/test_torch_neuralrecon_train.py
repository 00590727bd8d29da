"""Training parity, JAX vs the port on the CPU in float32: ``loss_fn``'s value,
its per-level losses and every parameter's gradient against
``jax.value_and_grad(loss_fn)``, then a 3-step clip + Adam loss curve
against optax, with the state carried from step to step.  Dense pyramid
(16³) and block-sparse pyramid (32³, identical block ids at every step).

The JAX side runs the batched-views trunk (``BACKBONE2D.MODE="batch"``), the
only trunk the port has; off the TPU its per-level loss is the jnp path,
whose gradient equals the fused loss's ``_bwd`` except at tsdf == 0 exactly.
The weights are the port's seeded init, carried to JAX by ``to_flax_params``.

Tolerances, measured and then rounded up.  The losses of the first step
agree to 3.4e-6 (LOSS_RTOL).  Gradients do not agree to float32 rounding,
and the cause is not a rule of either backward: each module's VJP agrees
with its flax twin to ~1e-6 (tests/test_torch_module_grads.py), and the
chain of level-1 modules, fed the JAX framework's own level-1 input, gives
the JAX framework's gradient to every digit, fed the port's (which differs
by up to 5e-5 after the bf16 gather table and the convs' sum order) the
port's.  The backward is sensitive to its forward: a ReLU input within
that difference of 0 passes or blocks its gradient, and the GroupNorm
backward spreads the change over its whole group.  Measured per leaf: at
most 3.3e-3 (dense) and 2.1e-2 (block) off ``backbone2d``, 2.8e-2 and
3.7e-2 in ``backbone2d`` (its leaves sum every pixel's cotangent, which
cancels), and 1.6e-3 / 7.5e-3 over the whole gradient.  Adam's first steps
move every weight by about ±lr whatever its gradient's size, so the loss
curve then drifts: 2.0e-3 (dense) and 4.0e-3 (block) at step 3, per level
up to 1.3e-2.
"""
import numpy as np
import pytest
import torch

from deep3dmap_tpu_torch.models.frameworks import neuralrecon as torch_nr
from deep3dmap_tpu_torch.utils.from_flax import to_flax_params
from torch_slice_helpers import (leaf_rel_errors, run_jax_train,
                                 run_torch_train, train_fragments)

torch.set_num_threads(2)

LOSS_RTOL = 1e-5            # step 1: loss and per-level losses
CURVE_RTOL = 1e-2           # steps 2-3: the loss
CURVE_LEVEL_RTOL = 3e-2     # steps 2-3: per-level losses
GRAD_RTOL = 5e-2            # per leaf, off backbone2d
BACKBONE_GRAD_RTOL = 1e-1   # per leaf, backbone2d
GLOBAL_GRAD_RTOL = 2e-2     # the whole gradient
N_STEPS = 3

COMMON = dict(N_LAYER=3, VOXEL_SIZE=0.08,
              FUSION=dict(FUSION_ON=True, FULL=True), LW=[1.0, 0.8, 0.64],
              THRESHOLDS=[0, 0, 0], POS_WEIGHT=1.5,
              BACKBONE2D=dict(ARC="fpn-mnas-0.5", MODE="batch"))
CFGS = {
    "dense": (dict(COMMON, N_VOX=[16, 16, 16]), 16),
    "block": (dict(COMMON, N_VOX=[32, 32, 32], TRAIN_NUM_SAMPLE=[64, 256],
                   SPARSE_MODE="block", BLOCK_SIZE=8, MAX_BLOCKS=[None, 4, 24]),
              32),
}


@pytest.fixture(scope="module", params=sorted(CFGS))
def runs(request):
    cfg, n_vox = CFGS[request.param]
    frags = train_fragments(n_vox, N_STEPS)
    fw = torch_nr.NeuralRecon(cfg, device="cpu")
    fw.init(0, frags[0])
    j, _ = run_jax_train(cfg, to_flax_params(fw.net), frags)
    t, _ = run_torch_train(fw, frags)
    return request.param, j, t


def test_loss_and_block_ids_match_jax(runs):
    mode, j, t = runs
    for step, (a, b) in enumerate(zip(j, t)):
        assert len(a["ids"]) == len(b["ids"]) == (2 if mode == "block" else 0)
        for x, y in zip(a["ids"], b["ids"]):
            np.testing.assert_array_equal(x, y, err_msg=f"step {step}")
        assert sorted(a["logs"]) == sorted(b["logs"]) == [
            f"tsdf_occ_loss_{i}" for i in range(3)]
        for k in a["logs"]:
            np.testing.assert_allclose(
                b["logs"][k], a["logs"][k], err_msg=f"step {step} {k}",
                rtol=LOSS_RTOL if step == 0 else CURVE_LEVEL_RTOL)
    np.testing.assert_allclose(t[0]["loss"], j[0]["loss"], rtol=LOSS_RTOL)
    # the 3-step clip + Adam curve
    np.testing.assert_allclose([s["loss"] for s in t[1:]],
                               [s["loss"] for s in j[1:]], rtol=CURVE_RTOL)
    assert all(np.isfinite(s["grad_norm"]) and s["grad_norm"] > 0 for s in t)


def test_every_gradient_matches_jax(runs):
    mode, j, t = runs
    rel = leaf_rel_errors(j[0]["grads"], t[0]["grads"])
    assert len(rel) == 232
    whole = leaf_rel_errors({"g": _flat(j[0]["grads"])}, {"g": _flat(t[0]["grads"])})
    assert whole["g"] <= GLOBAL_GRAD_RTOL, f"{mode}: whole gradient off by {whole}"
    bad = {k: v for k, v in rel.items()
           if v > (BACKBONE_GRAD_RTOL if k.startswith("backbone2d/") else GRAD_RTOL)}
    assert not bad, f"{mode}: leaves off JAX's gradient: {bad}"


def _flat(tree):
    return np.concatenate([np.ravel(v) if not isinstance(v, dict) else _flat(v)
                           for _, v in sorted(tree.items())])
