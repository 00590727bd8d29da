"""Scalar accumulation buffer for training logs (port of
``deep3dmap_tpu/utils/log_buffer.py``).

Accumulates (value, count) pairs per key and averages over a window.  A
value may be a 0-d device tensor: ``update`` only keeps it, and ``average``
reads the window's tensors to the host in one copy per key, so a training
step that logs never waits for the device; only the logger's interval does.
The averages equal the JAX buffer's, which converts each value to a Python
float as it arrives.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch


def _to_floats(values) -> list:
    """Host floats of a list of Python numbers and 0-d tensors, the tensors
    read together."""
    idx = [i for i, v in enumerate(values) if isinstance(v, torch.Tensor)]
    out = list(values)
    if idx:
        host = torch.stack([values[i].detach().reshape(()) for i in idx]).cpu()
        for i, v in zip(idx, host.tolist()):
            out[i] = v
    return [float(v) for v in out]


class LogBuffer:
    def __init__(self):
        self.val_history: OrderedDict = OrderedDict()
        self.n_history: OrderedDict = OrderedDict()
        self.output: OrderedDict = OrderedDict()
        self.ready = False

    def clear(self):
        self.val_history.clear()
        self.n_history.clear()
        self.clear_output()

    def clear_output(self):
        self.output.clear()
        self.ready = False

    def update(self, vars: dict, count: int = 1):
        if not isinstance(vars, dict):
            raise TypeError(f"vars must be a dict, got {type(vars)}")
        for key, var in vars.items():
            if not isinstance(var, torch.Tensor):
                var = float(var)
            self.val_history.setdefault(key, []).append(var)
            self.n_history.setdefault(key, []).append(count)

    def average(self, n: int = 0):
        """Average the latest ``n`` values (0 = all)."""
        assert n >= 0
        for key in self.val_history:
            vals = self.val_history[key][-n:] if n else self.val_history[key]
            values = np.array(_to_floats(vals))
            nums = np.array(self.n_history[key][-n:] if n else self.n_history[key])
            self.output[key] = float((values * nums).sum() / max(nums.sum(), 1))
        self.ready = True
