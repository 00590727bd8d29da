"""The metric arithmetic: the idle share's interval union, the p95 over every
fragment, the loss kernels' bytes, the FLOP count on the reference, and the
per-layer readers."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from benchmark.harness import cells, trace, yardstick
from benchmark.reference import neuralrecon as ref


def test_union_and_gaps():
    iv = [(0, 10), (5, 20), (30, 40), (35, 38), (90, 120)]
    assert trace.union_seconds(iv, 0, 100) * 1e9 == pytest.approx(40)
    assert trace.gaps(iv, 0, 100) == [(20, 30), (40, 90)]
    assert trace.union_seconds([], 0, 100) == 0.0
    assert trace.gaps([], 0, 100) == [(0, 100)]


def test_gaps_named_by_the_host():
    ops = [(0, 100, "step", 1), (15, 35, "aten::mm", 1), (45, 60, "bwd", 2),
           (50, 55, "aten::add", 2)]
    named = trace.name_gaps([(20, 30), (40, 46), (52, 53)], ops)
    assert named == pytest.approx({"aten::mm": 10e-9, "step": 6e-9, "aten::add": 1e-9})


def test_p95_over_every_fragment():
    v = list(np.random.RandomState(0).exponential(70.0, 397))
    assert yardstick.percentile(v, 95) == pytest.approx(np.percentile(v, 95))
    assert yardstick.percentile([5.0], 95) == 5.0


def test_loss_bytes_as_perf_md_counts_them():
    """PERF.md §6 rows 1 and 1b: 17 B and 25 B a voxel at float32
    predictions and targets and a bool mask; the per-level bounds in ms."""
    n96, n48, n24 = 96 ** 3, 48 ** 3, 24 ** 3
    args = ("float32", "float32", "float32", "bool")
    assert yardstick.loss_fwd_bytes(n96, *args) == 17 * n96
    assert yardstick.loss_bwd_bytes(n96, *args) == 25 * n96
    bwd_ms = [yardstick.loss_bwd_bytes(n, *args) / yardstick.PEAK_BYTES_PER_S * 1e3
              for n in (n24, n48, n96)]
    assert [round(x, 6) for x in bwd_ms] == [0.000103, 0.000825, 0.006603]
    assert round(yardstick.loss_fwd_bytes(n96, *args) / 3.35e12 * 1e3, 6) == 0.00449
    lv = [dict(n=n, pred="float32", tsdf_t="float32", occ_t="float32", mask="bool")
          for n in (n24, n48, n96)]
    assert yardstick.loss_least_seconds(lv) == pytest.approx(
        42 * (n24 + n48 + n96) / 3.35e12)


def test_flops_of_a_conv_and_of_the_reference():
    x = torch.randn(2, 3, 8, 8, 8)
    w = torch.randn(4, 3, 3, 3, 3, requires_grad=True)
    fwd = yardstick.count_flops(lambda: torch.nn.functional.conv3d(x, w, padding=1))
    assert fwd == 2 * 2 * 8 ** 3 * 4 * 3 * 27
    both = yardstick.count_flops(
        lambda: torch.nn.functional.conv3d(x, w, padding=1).sum().backward())
    assert both == 2 * fwd            # the weight's gradient; x needs none

    cfg = dict(N_VOX=[16, 16, 16], VOXEL_SIZE=0.24, TRAIN_NUM_SAMPLE=[64, 512, 2048],
               BACKBONE2D=dict(ARC="fpn-mnas-0.5"))
    net = ref.RefNet(cfg)
    B, V, H, W = 1, 2, 32, 32
    imgs = torch.rand(B, V, H, W, 3)
    proj = torch.eye(4).expand(B, V, 3, 4, 4).clone()
    hid = [torch.zeros(B, c, d, d, d) for c, d in zip(net.cfg["channels"], net.cfg["dims"])]
    f = yardstick.count_flops(lambda: ref.forward(net, imgs, proj, torch.zeros(B, 3),
                                                  torch.eye(4)[None], hid))
    assert f > 0
    g = yardstick.count_flops(lambda: ref.forward(
        net, imgs, proj, torch.zeros(B, 3), torch.eye(4)[None], hid)["tsdf"][-1].sum().backward())
    assert 2.9 * f < g < 3.1 * f     # forward, then backward at about twice


class _Trace:
    window_s, busy_s = 2.0, 0.5
    kernels = [("loss_kernel_0d1", 0, 4000), ("loss_bwd_kernel", 0, 6000), ("gemm", 0, 10)]

    def kernel_seconds(self, prefixes):
        return trace.Traced.kernel_seconds(self, prefixes)


def _reader(name):
    path = os.path.join(cells.BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"m_{abs(hash(name))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_readers():
    ctx = dict(kind="train", trace=_Trace(), units=20, window_s=10.0, units_traced=2,
               flops_per_unit=5e12, peak_flops=989e12, loss_least_s=2e-6)
    assert _reader("launches_per_step.train")(ctx) == 1.5
    assert _reader("loss_roofline.train")(ctx) == pytest.approx(100 * 2e-6 * 2 / 10e-6)
    assert _reader("mfu.train")(ctx) == pytest.approx(100 * 5e12 * 20 / 10.0 / 989e12)
    assert _reader("device_idle_pct.train")(ctx) == pytest.approx(75.0)
    for name in ("launches_per_fragment.stream", "mfu.stream", "device_idle_pct.stream"):
        assert _reader(name)(ctx) is None                   # a training cell's context
    bare = _Trace()
    bare.kernels = [("gemm", 0, 10)]
    assert _reader("loss_roofline.train")(dict(ctx, trace=bare)) is None
    sctx = dict(ctx, kind="stream")
    assert _reader("launches_per_fragment.stream")(sctx) == 1.5
    assert _reader("mfu.stream")(dict(sctx, flops_per_unit=None)) is None
