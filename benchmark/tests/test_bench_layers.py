"""The traced window put down to the program's spans (``harness/layers.py``),
on synthetic events as the profiler gives them."""
import pytest

from benchmark.harness import layers, trace
from benchmark.harness.layers import Ev

NODE = layers.NODE


def _span(name, s, e, th=1, corr=0):
    return Ev("span:" + name, "user_annotation", s, e, th, corr=corr)


def _op(name, s, e, th=1, corr=0, seq=-1, fwd_tid=0):
    return Ev(name, "cpu_op", s, e, th, corr=corr, seq=seq, fwd_tid=fwd_tid)


def _kernel(name, s, e, linked=0, corr=0):
    return Ev(name, "kernel", s, e, 0, device=True, corr=corr, linked=linked)


def _events():
    """A step on thread 1 (forward: a conv in ``nr.l1.net3d``, a cat in the
    ``block_sparse.gather_halo`` nested in it; backward on thread 2: the
    cat's node,
    then an AccumulateGrad node no forward op matches), a kernel known only
    by its runtime call inside ``step``, one launched outside every span, a
    device-to-host copy and a synchronisation."""
    host = [
        _span("step", 0, 1000), _span("step.forward", 0, 500),
        _span("nr.l1.net3d", 100, 300), _span("block_sparse.gather_halo", 150, 250),
        _op("aten::conv3d", 110, 140, corr=10, seq=5),
        _op("aten::cat", 160, 200, corr=11, seq=6),
        _span("step.backward", 500, 900),
        _op(NODE + "CatBackward0", 600, 700, th=2, seq=6, fwd_tid=1),
        _op("aten::slice_backward", 610, 650, th=2, corr=12),
        _op(NODE + "torch::autograd::AccumulateGrad", 750, 800, th=2),
        _op("aten::add_", 760, 790, th=2, corr=13),
        _op("aten::copy_", 1100, 1110, corr=14),
    ]
    runtime = [Ev("cudaLaunchKernel", "cuda_runtime", 950, 952, 99, corr=50),
               Ev("cudaMemcpyAsync", "cuda_runtime", 162, 170, 99, corr=51, linked=11),
               Ev("cudaStreamSynchronize", "cuda_runtime", 1140, 1190, 99, corr=52, linked=14)]
    dev = [_kernel("conv", 120, 180, linked=10), _kernel("cat", 200, 260, linked=11),
           _kernel("Memcpy DtoH (Device -> Pageable)", 260, 262, corr=51, linked=11),
           _kernel("slice_bwd", 620, 640, linked=12), _kernel("add", 770, 780, linked=13),
           _kernel("runtime_only", 960, 970, linked=999, corr=50),
           _kernel("outside", 1120, 1130, linked=14)]
    return host + runtime + dev


@pytest.fixture(scope="module")
def att():
    return layers.attribute(_events(), 0, 1200, units=2)


def test_a_kernel_goes_to_the_innermost_span(att):
    L = att["layers"]
    assert L["nr.l1.net3d"]["fwd_kernels"] * 2 == 1           # conv, per unit
    # the cat's kernel and its copy: inside gather_halo, nested in net3d
    assert L["block_sparse.gather_halo"]["fwd_kernels"] * 2 == 1
    assert L["block_sparse.gather_halo"]["fwd_ms"] * 2 == pytest.approx((60 + 2) * 1e-6)
    assert L["step"]["fwd_kernels"] * 2 == 1                   # by its runtime call
    assert L["block_sparse.gather_halo"]["calls"] * 2 == 1
    assert L["step"]["host_ms"] * 2 == pytest.approx(1000e-6)


def test_a_backward_kernel_goes_to_its_forward_span(att):
    L = att["layers"]
    assert L["block_sparse.gather_halo"]["bwd_kernels"] * 2 == 1   # the cat's backward
    assert L["block_sparse.gather_halo"]["bwd_ms"] * 2 == pytest.approx(20e-6)
    # no forward op has AccumulateGrad's number: the step's backward takes it
    assert L["step.backward"]["fwd_kernels"] * 2 == 1


def test_each_kernel_and_gap_counts_once(att):
    L = att["layers"]
    n = sum(r["fwd_kernels"] + r["bwd_kernels"] for r in L.values()) * 2
    assert n == 6                                   # 7 device ops, one of them a copy
    dev_ms = sum(r["fwd_ms"] + r["bwd_ms"] for r in L.values()) * 2
    assert dev_ms == pytest.approx(att["device_ms"]) and att["device_ms"] == pytest.approx(
        (60 + 60 + 2 + 20 + 10 + 10 + 10) * 1e-6)
    busy = trace.union_seconds([(120, 180), (200, 262), (620, 640), (770, 780), (960, 970),
                                (1120, 1130)], 0, 1200) * 1e3
    idle = sum(r["idle_ms"] for r in L.values()) * 2
    assert idle == pytest.approx(1200e-6 - busy) and att["busy_ms"] == pytest.approx(busy)
    # each gap by what was open at its start (thread 2's node began last)
    want = {"step.forward": 120, "block_sparse.gather_halo": 20 + 130, "nr.l1.net3d": 358,
            "step.backward": 180, "step": 150, "(none)": 70}
    got = {k: r["idle_ms"] * 2 / 1e-6 for k, r in L.items() if r["idle_ms"]}
    assert got == pytest.approx(want)
    assert L["(none)"]["fwd_kernels"] * 2 == 1                # launched outside every span
    assert att["shares"]["busy_attributed"] == pytest.approx(1 - 10 / 172)


def test_host_waits_by_span(att):
    assert att["host_waits"] == {
        "block_sparse.gather_halo": {"cudaMemcpyAsync": [1, pytest.approx(8e-6)]},
        "(none)": {"cudaStreamSynchronize": [1, pytest.approx(50e-6)]}}


def test_shares_of_the_idle_time(att):
    idle = 1200 - (60 + 62 + 20 + 10 + 10 + 10)
    sh = att["shares"]
    assert sh["idle_to_layers"] == pytest.approx((150 + 358) / idle)
    assert sh["idle_no_host_op"] == pytest.approx(70 / idle)   # after the last op


def test_kind_from_the_name_without_activity_type():
    """Older torch's events have no ``activity_type``: the kind then comes
    from the device, the annotation flag and the name."""
    class E:
        def __init__(self, name, ann=False):
            self._name, self._ann = name, ann

        def name(self):
            return self._name

        def is_user_annotation(self):
            return self._ann
    assert layers._kind(E("span:nr.trunk", True), False) == "user_annotation"
    assert layers._kind(E("aten::cat"), False) == "cpu_op"
    assert layers._kind(E("cudaLaunchKernel"), False) == "cuda_runtime"
    assert layers._kind(E("cuLaunchKernel"), False) == "cuda_runtime"
    assert layers._kind(E("gemm"), True) == "kernel"


@pytest.mark.cuda
def test_spans_leave_the_trace_readers_alone():
    """On the card: a window with the program's spans open has the same
    kernels, device ops and busy time as without them (their mirrors on the
    device's timeline are not device work)."""
    import torch

    from deep3dmap_tpu_torch.utils.tracing import span

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x = torch.randn(256, 256, device="cuda")

    def work(with_spans):
        def fn():
            for _ in range(4):
                with (span("nr.l1.net3d") if with_spans else torch.no_grad()):
                    y = (x @ x).relu().sum()
            torch.cuda.synchronize()
            return y
        return fn
    work(False)()
    a, b = trace.Traced(work(False)), trace.Traced(work(True))
    assert [k[0] for k in a.kernels] == [k[0] for k in b.kernels]
    assert [d[0] for d in a.device_ops] == [d[0] for d in b.device_ops]
