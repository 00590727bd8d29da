"""The fused-loss Triton kernels (forward and backward) against their plain
versions, on the card.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only the port's requirements:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_loss_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets JAX up.)  Without a CUDA
device every test here skips.
"""
import numpy as np
import pytest
import torch

from deep3dmap_tpu_torch.ops import fused_loss

RTOL = 1e-4   # float32 sums of up to 884,736 terms, in another order
# backward: elementwise, the same ops (sigmoid, log and FMAs may differ by an
# ulp); a bf16 gradient may round one f32 ulp to the next bf16 value
BWD_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-12),
           torch.bfloat16: dict(rtol=2 ** -7, atol=1e-12)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Triton kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(n, device, pred_dtype=torch.float32):
    rng = np.random.RandomState(n)
    tsdf = rng.uniform(-1, 1, n).astype(np.float32)
    occ = rng.randn(n).astype(np.float32)
    tsdf_t = rng.uniform(-1, 1, n).astype(np.float32)
    occ_t = rng.rand(n) > 0.7
    mask = rng.rand(n) > 0.3
    t = [torch.from_numpy(a).to(device) for a in (tsdf, occ, tsdf_t, occ_t, mask)]
    t[0], t[1] = t[0].to(pred_dtype), t[1].to(pred_dtype)
    t[3] = t[3].float()
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("n", [24 ** 3, 48 ** 3, 96 ** 3, 1000])
@pytest.mark.parametrize("pred_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_matches_plain_on_card(cuda_device, n, pred_dtype):
    data = _inputs(n, cuda_device, pred_dtype)
    before = fused_loss.launches
    got = fused_loss.fused_tsdf_occ_loss(*data, pos_weight=1.5)
    want = fused_loss.fused_tsdf_occ_loss_plain(*data, pos_weight=1.5)
    assert fused_loss.launches == before + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=RTOL)
    again = fused_loss.fused_tsdf_occ_loss(*data, pos_weight=1.5)
    for a, b in zip(got, again):  # fixed reduction order: bitwise repeatable
        assert float(a) == float(b)


@pytest.mark.cuda
def test_kernel_empty_target_and_zero_mask(cuda_device):
    data = _inputs(48 ** 3, cuda_device)
    empty = list(data)
    empty[3] = torch.zeros_like(data[3])
    assert float(fused_loss.fused_tsdf_occ_loss(*empty, pos_weight=1.5)[0]) == 0.0
    zero = list(data)
    zero[4] = torch.zeros_like(data[4])
    out = fused_loss.fused_tsdf_occ_loss(*zero, pos_weight=1.5)
    assert all(float(v) == 0.0 for v in out)


@pytest.mark.cuda
def test_kernel_back_to_back_two_sizes(cuda_device):
    """Calls of two sizes (many programs, then few) in turns without a sync:
    each equals its size's first result bit for bit, so the last program
    resets the ticket every time."""
    data = {n: _inputs(n, cuda_device) for n in (96 ** 3, 24 ** 3)}
    order = [96 ** 3, 24 ** 3, 24 ** 3, 96 ** 3, 24 ** 3, 96 ** 3]
    outs = [torch.stack(fused_loss.fused_tsdf_occ_loss(*data[n], pos_weight=1.5))
            for n in order]
    for n in data:
        got = [o for o, k in zip(outs, order) if k == n]
        assert all(torch.equal(g, got[0]) for g in got)
        want = fused_loss.fused_tsdf_occ_loss_plain(*data[n], pos_weight=1.5)
        for g, w in zip(got[0], want):
            np.testing.assert_allclose(float(g), float(w), rtol=RTOL)


def _bwd_pair(data, g):
    """The autograd Function's backward on the card (the Triton kernel)
    against ``fused_tsdf_occ_loss_bwd_plain`` on the same inputs and sums."""
    t = data[0].clone().requires_grad_()
    x = data[1].clone().requires_grad_()
    before = (fused_loss.launches, fused_loss.bwd_launches)
    out = fused_loss.fused_tsdf_occ_loss(t, x, *data[2:], pos_weight=1.5)
    gv = torch.tensor(g, device=t.device)
    got = torch.autograd.grad(out, (t, x), list(gv.unbind()))
    assert (fused_loss.launches, fused_loss.bwd_launches) == (before[0] + 1,
                                                             before[1] + 1)
    sums = fused_loss.partial_sums_plain(*data)[:2]
    want = fused_loss.fused_tsdf_occ_loss_bwd_plain(*data, sums, gv, pos_weight=1.5)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), **BWD_TOL[a.dtype])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n", [24 ** 3, 48 ** 3, 96 ** 3, 1000])
@pytest.mark.parametrize("pred_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_bwd_kernel_matches_plain_on_card(cuda_device, n, pred_dtype):
    _bwd_pair(_inputs(n, cuda_device, pred_dtype), (1.0, 0.0, 0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("g", [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
                               (0.7, -0.3, 2.0)])
def test_bwd_kernel_each_cotangent(cuda_device, g):
    _bwd_pair(_inputs(48 ** 3, cuda_device), g)


@pytest.mark.cuda
def test_bwd_kernel_empty_target_and_zero_mask(cuda_device):
    data = _inputs(48 ** 3, cuda_device)
    empty = list(data)
    empty[3] = torch.zeros_like(data[3])
    d_t, _ = _bwd_pair(empty, (1.0, 0.5, 0.25))
    assert not d_t.any()
    zero = list(data)
    zero[4] = torch.zeros_like(data[4])
    assert not any(d.any() for d in _bwd_pair(zero, (1.0, 0.5, 0.25)))


def _levels_pair(levels, g):
    """The levels' autograd Function on the card (one backward launch for up
    to three levels) against ``fused_tsdf_occ_loss_bwd_plain`` on each level,
    given the plain sums and that level's row of the cotangents ``g``."""
    ins = [(d[0].clone().requires_grad_(), d[1].clone().requires_grad_(), *d[2:])
           for d in levels]
    gv = torch.tensor(g, device=levels[0][0].device)
    before = (fused_loss.launches, fused_loss.bwd_launches)
    losses = fused_loss.fused_tsdf_occ_loss_levels(ins, pos_weight=1.5)
    got = torch.autograd.grad(losses, [p for lv in ins for p in lv[:2]], gv)
    losses = losses.detach()
    n_bwd = -(-len(levels) // 3)
    assert (fused_loss.launches, fused_loss.bwd_launches) == (
        before[0] + len(levels), before[1] + n_bwd)
    for i, d in enumerate(levels):
        want_losses = fused_loss.fused_tsdf_occ_loss_plain(*d, pos_weight=1.5)
        for a, b in zip(losses[i], want_losses):
            np.testing.assert_allclose(float(a), float(b), rtol=RTOL)
        sums = fused_loss.partial_sums_plain(*d)[:2]
        want = fused_loss.fused_tsdf_occ_loss_bwd_plain(*d, sums, gv[i], pos_weight=1.5)
        for a, b in zip(got[2 * i:2 * i + 2], want):
            assert a.dtype == b.dtype and a.shape == b.shape
            torch.testing.assert_close(a.float(), b.float(), **BWD_TOL[a.dtype])
    return got


def _levels_inputs(device, sizes, pred_dtypes=None):
    levels = [_inputs(n, device, p) for n, p in
              zip(sizes, pred_dtypes or [torch.float32] * len(sizes))]
    # loss_fn's dtypes: float32 predictions and targets, a bool mask
    return [tuple(t.reshape(-1) for t in lv) for lv in levels]


LEVEL_SETS = {
    "bench_24_48_96": ([24 ** 3, 48 ** 3, 96 ** 3], None),
    "ragged": ([1000003, 4097, 693], [torch.bfloat16, torch.float32, torch.float32]),
    "one_level": ([96 ** 3], None),
    "four_levels": ([512, 24 ** 3, 48 ** 3, 96 ** 3], None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LEVEL_SETS))
def test_levels_kernel_matches_plain_on_card(cuda_device, name):
    """One backward launch for up to three levels (two for four), each
    level against the plain backward under its own cotangents; two runs
    give the same bits."""
    sizes, dtypes = LEVEL_SETS[name]
    levels = _levels_inputs(cuda_device, sizes, dtypes)
    g = [[0.7, -0.3, 2.0], [1.0, 0.5, 0.25], [0.0, 1.0, 0.0], [0.64, 0.0, 0.1]]
    g = g[:len(levels)]
    got = _levels_pair(levels, g)
    again = _levels_pair(levels, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
