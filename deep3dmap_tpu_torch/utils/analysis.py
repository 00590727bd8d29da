"""Model complexity: parameters and FLOPs (port of
``deep3dmap_tpu/utils/analysis.py``).

JAX reads XLA's cost analysis of the compiled program; the port counts with
``torch.utils.flop_counter.FlopCounterMode`` on one eager call.  The two
agree on matrix products and convolutions (2 * M * N * K each) and differ
on elementwise work, which XLA counts and the flop counter does not.
``bytes_accessed`` is the bytes every operator of the call reads and writes
(each input and output tensor once per operator), where XLA counts after
fusion: an upper bound of XLA's figure.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode


def count_params(params) -> int:
    """Number of values in an ``nn.Module``'s parameters or in a (nested)
    dict / list of tensors or arrays."""
    if isinstance(params, nn.Module):
        return int(sum(p.numel() for p in params.parameters()))
    leaves, _ = tree_flatten(params)
    return int(sum(int(getattr(x, "numel", lambda: x.size)()) for x in leaves
                   if hasattr(x, "shape")))


class _ByteCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten((args, kwargs, out))[0]:
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


def _fmt(x, unit=""):
    for mag, suf in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if x >= mag:
            return f"{x / mag:.2f} {suf}{unit}"
    return f"{x:.0f} {unit}"


def get_model_complexity_info(fn: Callable, *args) -> dict:
    """Run ``fn(*args)`` once and count.  Returns dict(flops,
    bytes_accessed, flops_readable, bytes_readable) and, when ``args[0]``
    is a module or a dict of parameters, params and params_readable."""
    counter, nbytes = FlopCounterMode(display=False), _ByteCounter()
    with torch.no_grad(), counter, nbytes:
        fn(*args)
    flops = float(counter.get_total_flops())
    out = dict(flops=flops, bytes_accessed=float(nbytes.bytes),
               flops_readable=_fmt(flops, "FLOPs"),
               bytes_readable=_fmt(float(nbytes.bytes), "B"))
    if args and isinstance(args[0], (dict, nn.Module)):
        out["params"] = count_params(args[0])
        out["params_readable"] = _fmt(out["params"])
    return out
