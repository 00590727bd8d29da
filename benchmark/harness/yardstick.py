"""What the numbers are measured against: the card's peaks, the bytes the
loss kernels need, the operations a step needs (counted on the reference).

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit."""
from __future__ import annotations

from typing import Callable, Sequence

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

_SIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "bool": 1, "uint8": 1}


def loss_fwd_bytes(n: int, pred: str, tsdf_t: str, occ_t: str, mask: str) -> int:
    """``loss_kernel`` at one level of ``n`` voxels: the two predictions, the
    two targets and the mask read once (PERF.md §6 row 1; its 96³ case with
    float32 predictions and targets and a bool mask is 17 B a voxel)."""
    return n * (2 * _SIZE[pred] + _SIZE[tsdf_t] + _SIZE[occ_t] + _SIZE[mask])


def loss_bwd_bytes(n: int, pred: str, tsdf_t: str, occ_t: str, mask: str) -> int:
    """``loss_bwd_kernel`` at one level: the five inputs read once and the two
    gradients, in the predictions' type, written once (PERF.md §6 row 1b,
    25 B a voxel in that case)."""
    return loss_fwd_bytes(n, pred, tsdf_t, occ_t, mask) + n * 2 * _SIZE[pred]


def loss_least_seconds(levels: Sequence[dict]) -> float:
    """Least time of one step's loss kernels (every level forward, one
    backward over all levels), bound by bytes at the HBM peak.  ``levels``:
    dicts with ``n`` and the four dtypes."""
    total = 0
    for lv in levels:
        args = (lv["n"], lv["pred"], lv["tsdf_t"], lv["occ_t"], lv["mask"])
        total += loss_fwd_bytes(*args) + loss_bwd_bytes(*args)
    return total / PEAK_BYTES_PER_S


def count_flops(fn: Callable[[], None]) -> int:
    """Floating-point operations of the matmuls and convolutions ``fn`` runs
    (forward and, if it calls it, backward), by ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of every value, linear between ranks."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
