"""Batch normalization with statistics taken across ranks (port of
``deep3dmap_tpu/models/modulars/norm.py``).

flax's ``BatchNorm``, the port's own, not ``torch.nn.SyncBatchNorm``: the
features on the last axis; batch statistics E[x] and E[x²] over every
other axis in float32, averaged over ``group`` in one all-reduce (flax's
``pmean`` over ``axis_name``); the biased variance by flax's fast rule
max(E[x²] − E[x]², 0); y = (x − mean) · (rsqrt(var + ε) · scale) + bias.
The running statistics decay by ``momentum`` (0.9, flax's convention:
torch's 1 − momentum).  Without a group it is plain BatchNorm, as JAX's
falls back outside ``shard_map``.  The averages assume the ranks hold
equal batches, as ``pmean`` does.

Parameters ``bn.scale`` and ``bn.bias``, buffers ``bn.mean`` and
``bn.var``: flax's ``params`` and ``batch_stats`` under ``bn``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ...parallel.collectives import AllReduceSum, group_size


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis (``use_fast_variance``)."""

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, use_running_average: bool, group=None):
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            axes = tuple(range(x.dim() - 1))
            xf = x.float()
            stats = torch.cat([xf.mean(axes), (xf * xf).mean(axes)])
            if group is not None:
                stats = AllReduceSum.apply(stats, group) / group_size(group)
            mean, mean2 = stats.chunk(2)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():        # flax updates them on every such call
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        # float32 out, as flax promotes a bf16 input with its float32 scale
        return (x.float() - mean) * mul + self.bias


class SyncBatchNorm(nn.Module):
    """BatchNorm whose statistics are averaged over ``group`` (a process
    group of the ``data`` axis, ``Mesh.group("data")``), as JAX's is over
    its ``axis_name``.  ``use_running_average=True`` is eval mode."""

    def __init__(self, features: int, group=None,
                 use_running_average: Optional[bool] = None, momentum: float = 0.9,
                 epsilon: float = 1e-5):
        super().__init__()
        self.group = group
        self.use_running_average = use_running_average
        self.bn = BatchNorm(features, momentum, epsilon)

    def forward(self, x, use_running_average: Optional[bool] = None):
        ura = (use_running_average if use_running_average is not None
               else self.use_running_average)
        if ura is None:
            raise ValueError("SyncBatchNorm: use_running_average is set neither at "
                             "construction nor at the call")
        return self.bn(x, ura, self.group)
