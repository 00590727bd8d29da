"""Running and total average meters for console reports (the port's copy
of ``deep3dmap_tpu/utils/meters.py``).
"""
from __future__ import annotations

from collections import OrderedDict


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)


class StandardMetrics:
    """Named collection of AverageMeters."""

    def __init__(self):
        self.metrics: OrderedDict = OrderedDict()

    def update(self, vars: dict, n: int = 1):
        for k, v in vars.items():
            self.metrics.setdefault(k, AverageMeter()).update(v, n)

    def averages(self) -> dict:
        return {k: m.avg for k, m in self.metrics.items()}

    def reset(self):
        self.metrics.clear()

    def __repr__(self):
        return " ".join(f"{k}={m.avg:.4f}" for k, m in self.metrics.items())
