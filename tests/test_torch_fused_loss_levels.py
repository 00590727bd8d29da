"""Port parity: the fused loss over several levels at once
(``fused_tsdf_occ_loss_levels``, the autograd Function whose backward is one
kernel launch for every level on the card).

On the CPU the Function takes the plain versions level by level.  Each
level's losses and gradients are held against the JAX Pallas kernel in
interpret mode and ``jax.vjp`` through its custom VJP (``_bwd``), with the
tolerances of tests/test_torch_fused_loss.py; the Function at L = 1 against
``fused_tsdf_occ_loss``; and ``NeuralRecon.loss_fn``, which makes one call
for its levels, against per-level calls with the float32 mask that the
framework built before (bitwise).  The kernel itself runs only on a GPU:
its test is ``tests/test_torch_fused_loss_cuda.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deep3dmap_tpu.ops.pallas_loss import fused_tsdf_occ_loss as jax_fused
from deep3dmap_tpu_torch.datasets.builder import _stack_samples
from deep3dmap_tpu_torch.datasets.synthetic import make_fragment_sample
from deep3dmap_tpu_torch.models.frameworks import neuralrecon as torch_nr
from deep3dmap_tpu_torch.ops import fused_loss

torch.set_num_threads(2)

RTOL = 1e-5  # fp32 sums, different summation order
# backward, f32: elementwise, the same ops; sigmoid and log differ by an ulp
GRAD_TOL = dict(rtol=1e-5, atol=1e-10)
# backward into bf16 predictions: an ulp of f32 may round to the next bf16
GRAD_TOL_BF16 = dict(rtol=2 ** -7, atol=1e-10)
POS_WEIGHT = 1.5


def _level(rng, shape, pred=np.float32, mask_bool=True, empty_target=False,
           zero_mask=False):
    """One level as numpy arrays: predictions in ``pred`` (float32 or the
    string "bf16"), float32 targets, a bool or float32 mask."""
    tsdf = rng.uniform(-1, 1, shape).astype(np.float32)
    occ = (rng.randn(*shape) * 2).astype(np.float32)
    tsdf_t = rng.uniform(-1, 1, shape).astype(np.float32)
    occ_t = (rng.rand(*shape) > 0.7).astype(np.float32)
    mask = rng.rand(*shape) > 0.3
    if empty_target:
        occ_t[...] = 0
    if zero_mask:
        mask[...] = False
    return dict(arrays=(tsdf, occ, tsdf_t, occ_t,
                        mask if mask_bool else mask.astype(np.float32)),
                bf16=pred == "bf16")


CASES = {
    # NeuralRecon's pyramid at a small size, finest level last as in loss_fn
    "three_sizes": [dict(shape=(1, 4, 4, 4)), dict(shape=(1, 8, 8, 8)),
                    dict(shape=(1, 16, 16, 16))],
    # sizes that fill no whole tile, one of them prime
    "ragged": [dict(shape=(10, 10, 10)), dict(shape=(997,)),
               dict(shape=(3, 5, 7))],
    "bf16_predictions": [dict(shape=(2, 6, 6, 6), pred="bf16"),
                         dict(shape=(1, 12, 12, 12), pred="bf16")],
    "bool_and_f32_mask": [dict(shape=(1, 8, 8, 8), mask_bool=True),
                          dict(shape=(1, 8, 8, 8), mask_bool=False)],
    "empty_target_level": [dict(shape=(1, 8, 8, 8)),
                           dict(shape=(1, 8, 8, 8), empty_target=True)],
    "zero_mask_level": [dict(shape=(1, 8, 8, 8), zero_mask=True),
                        dict(shape=(1, 12, 12, 12))],
    "four_levels": [dict(shape=(1, 4, 4, 4)), dict(shape=(1, 6, 6, 6)),
                    dict(shape=(1, 8, 8, 8)), dict(shape=(1, 10, 10, 10))],
}


def _torch_level(lv, requires_grad=True):
    t, x, *rest = (torch.from_numpy(a) for a in lv["arrays"])
    if lv["bf16"]:
        t, x = t.bfloat16(), x.bfloat16()
    return (t.requires_grad_(requires_grad), x.requires_grad_(requires_grad),
            *rest)


def _jax_level(lv, g):
    """(losses, (d_tsdf, d_occ)) of the Pallas kernel in interpret mode and
    its custom VJP under the cotangents ``g``, on the port's inputs."""
    t, x, *rest = (jnp.asarray(a) for a in lv["arrays"])
    if lv["bf16"]:
        t, x = t.astype(jnp.bfloat16), x.astype(jnp.bfloat16)
    losses, vjp = jax.vjp(lambda a, b: jax_fused(a, b, *rest, POS_WEIGHT, True), t, x)
    grads = vjp(tuple(jnp.float32(v) for v in g))
    return ([float(v) for v in losses],
            [np.asarray(d.astype(jnp.float32)) for d in grads])


@pytest.mark.parametrize("case", sorted(CASES))
def test_levels_match_jax_per_level(rng, case):
    """Every level's losses and gradients, under cotangents that differ per
    level, against JAX's kernel and ``_bwd`` on that level alone; no kernel
    launches for CPU tensors."""
    levels = [_level(rng, **kw) for kw in CASES[case]]
    g = rng.uniform(-1, 2, (len(levels), 3)).astype(np.float32)
    ins = [_torch_level(lv) for lv in levels]
    before = (fused_loss.launches, fused_loss.bwd_launches)
    losses = fused_loss.fused_tsdf_occ_loss_levels(ins, pos_weight=POS_WEIGHT)
    assert losses.shape == (len(levels), 3) and losses.dtype == torch.float32
    preds = [p for lv in ins for p in lv[:2]]
    grads = torch.autograd.grad(losses, preds, torch.from_numpy(g))
    assert (fused_loss.launches, fused_loss.bwd_launches) == before
    for i, lv in enumerate(levels):
        want_losses, want_grads = _jax_level(lv, g[i])
        np.testing.assert_allclose(losses[i].detach().numpy(), want_losses,
                                   rtol=RTOL, atol=1e-7, err_msg=f"level {i}")
        for name, a, p, b in zip(("d_tsdf", "d_occ"), grads[2 * i:2 * i + 2],
                                 ins[i][:2], want_grads):
            assert a.dtype == p.dtype and a.shape == p.shape
            tol = GRAD_TOL_BF16 if lv["bf16"] else GRAD_TOL
            np.testing.assert_allclose(a.float().numpy(), b,
                                       err_msg=f"level {i} {name}", **tol)


def test_empty_target_and_zero_mask_levels_give_zero_gradients(rng):
    """A level without positives has no tsdf gradient; an all-zero mask
    gives no gradient at all, whatever the other levels hold."""
    levels = [_level(rng, (1, 8, 8, 8), empty_target=True),
              _level(rng, (1, 8, 8, 8), zero_mask=True),
              _level(rng, (1, 8, 8, 8))]
    ins = [_torch_level(lv) for lv in levels]
    losses = fused_loss.fused_tsdf_occ_loss_levels(ins, pos_weight=POS_WEIGHT)
    g = torch.tensor([[1.0, 0.5, 0.25]] * 3)
    grads = torch.autograd.grad(losses, [p for lv in ins for p in lv[:2]], g)
    losses = losses.detach()
    assert float(losses[0, 0]) == 0.0 and not grads[0].any() and grads[1].any()
    assert not losses[1].any() and not grads[2].any() and not grads[3].any()
    assert grads[4].any() and grads[5].any()


@pytest.mark.parametrize("pred", [np.float32, "bf16"], ids=["f32", "bf16"])
def test_one_level_equals_fused_tsdf_occ_loss(rng, pred):
    """At L = 1 the Function is ``fused_tsdf_occ_loss``, bit for bit."""
    lv = _level(rng, (2, 6, 6, 6), pred=pred)
    a, b = _torch_level(lv), _torch_level(lv)
    got = fused_loss.fused_tsdf_occ_loss_levels([a], pos_weight=POS_WEIGHT)
    want = torch.stack(fused_loss.fused_tsdf_occ_loss(*b, pos_weight=POS_WEIGHT))
    assert torch.equal(got[0], want)
    g = torch.tensor([0.7, -0.3, 2.0])
    ga = torch.autograd.grad(got[0], a[:2], g)
    gb = torch.autograd.grad(want, b[:2], g)
    for x, y in zip(ga, gb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_levels_reject_bad_input(rng):
    lv = _torch_level(_level(rng, (1, 4, 4, 4)), requires_grad=False)
    with pytest.raises(ValueError, match="non-empty"):
        fused_loss.fused_tsdf_occ_loss_levels([], pos_weight=1.0)
    with pytest.raises(ValueError, match="shapes differ"):
        fused_loss.fused_tsdf_occ_loss_levels([lv, (lv[0][..., :2],) + lv[1:]])
    with pytest.raises(ValueError, match="CUDA device"):
        fused_loss.fused_tsdf_occ_loss_levels(
            [lv, tuple(a.to("meta") for a in lv)])


# ------------------------------------------------------------- loss_fn --
COMMON = dict(N_LAYER=3, VOXEL_SIZE=0.08, LW=[1.0, 0.8, 0.64],
              THRESHOLDS=[0, 0, 0], POS_WEIGHT=1.5,
              BACKBONE2D=dict(ARC="fpn-mnas-0.5", MODE="batch"))
LOSS_FN_CFGS = {
    "dense_full_fusion": (dict(COMMON, N_VOX=[16, 16, 16],
                               FUSION=dict(FUSION_ON=True, FULL=True)), 16),
    # the mask is sparse_mask & count_mask here
    "dense_no_fusion": (dict(COMMON, N_VOX=[16, 16, 16],
                             FUSION=dict(FUSION_ON=False, FULL=False)), 16),
    "block": (dict(COMMON, N_VOX=[32, 32, 32], TRAIN_NUM_SAMPLE=[64, 256],
                   FUSION=dict(FUSION_ON=True, FULL=True), SPARSE_MODE="block",
                   BLOCK_SIZE=8, MAX_BLOCKS=[None, 4, 24]), 32),
}


def _per_level_loss(fw, net, state, batch):
    """``loss_fn`` as one call per level: ``fused_tsdf_occ_loss`` on
    ``[..., 0]`` of the predictions with a float32 mask."""
    batch = fw.batch_to_device(batch)
    net.train()
    out, _ = fw._apply(net, state, batch)
    total, logs = 0.0, {}
    for i in range(fw.n_layers):
        scale = fw.n_layers - 1 - i
        mask = out["sparse_mask"][i].float()
        if not (fw.fusion_on and fw.fusion_full):
            mask = mask * out["count_mask"][i].float()
        level, _, _ = fused_loss.fused_tsdf_occ_loss(
            out["tsdf"][i][..., 0], out["occ"][i][..., 0],
            batch["tsdf_list"][scale], batch["occ_list"][scale], mask, fw.pos_weight)
        total = total + fw.lw[i] * level
        logs[f"tsdf_occ_loss_{i}"] = level
    return total, logs


@pytest.mark.parametrize("mode", sorted(LOSS_FN_CFGS))
def test_loss_fn_bitwise_as_per_level_calls(mode):
    """``loss_fn`` (one call for its levels, a bool mask, squeezed
    predictions) gives the loss, the per-level losses and every parameter's
    gradient of per-level calls with a float32 mask, bit for bit."""
    cfg, n_vox = LOSS_FN_CFGS[mode]
    batch = _stack_samples([make_fragment_sample(
        seed=0, n_views=2, img_size=(64, 64), n_vox=n_vox, voxel_size=0.08,
        device="cpu")])
    batch["scene_reset"] = np.ones(1, np.float32)
    fw = torch_nr.NeuralRecon(cfg, device="cpu")
    fw.init(0, batch)
    state = fw.init_state(1)
    got, aux = fw.loss_fn(fw.net, state, batch)
    got.backward()
    got_grads = {n: p.grad.clone() for n, p in fw.net.named_parameters()}
    fw.net.zero_grad(set_to_none=True)
    want, logs = _per_level_loss(fw, fw.net, state, batch)
    want.backward()
    assert torch.equal(got, want)
    assert sorted(aux["log_vars"]) == sorted(logs)
    for k, v in logs.items():
        assert torch.equal(aux["log_vars"][k], v), k
    moved = 0
    for n, p in fw.net.named_parameters():
        assert (p.grad is None) == (got_grads[n] is None), n
        if p.grad is not None:
            assert torch.equal(got_grads[n], p.grad), n
            moved += int(p.grad.any())
    assert moved > 0
