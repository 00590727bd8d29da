"""FSDP / ZeRO placement (port of ``deep3dmap_tpu/parallel/fsdp.py``).

The specs are JAX's decisions as data: a tuple of ``PartitionSpec``
entries per array, the mesh axis on the sharded dimension and None on the
others, ``()`` for replicated.  Arrays below ``min_size`` elements stay
replicated (biases, norms); otherwise the largest dimension that divides
over the axis is sharded.

``fsdp_shard`` applies them to a module with FSDP2's ``fully_shard``: each
sharded parameter on its spec's dimension (``shard_placement_fn``).  FSDP2
cannot leave one parameter of a sharded module whole, so the replicated
ones are ``ignored_params``, and a hook averages their gradients over the
axis as FSDP's reduce-scatter averages the others.  ``zero_shard`` keeps an
optimizer's state for this rank's shard of each parameter the specs shard
(ZeRO-1): the parameters stay whole and are gathered back after each step.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import collectives
from .collectives import gather_rows, group_rank, group_size
from .mesh import Mesh, tree_leaves, tree_map


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(np.shape(x))


def fsdp_spec(x, mesh: Mesh, axis: str = "data", min_size: int = 2 ** 14) -> tuple:
    """FSDP spec of one array: its largest dimension that divides over
    ``axis`` sharded; arrays below ``min_size`` elements replicated."""
    if axis not in mesh.axis_names:
        return ()
    n = mesh.shape[axis]
    shape = _shape(x)
    if n <= 1 or int(np.prod(shape or (1,))) < min_size:
        return ()
    cands = [(d, i) for i, d in enumerate(shape) if d % n == 0]
    if not cands:
        return ()
    _, dim = max(cands)
    spec = [None] * len(shape)
    spec[dim] = axis
    return tuple(spec)


def fsdp_specs(params, mesh: Mesh, axis: str = "data", min_size: int = 2 ** 14):
    """The specs of a params tree (nested dicts of arrays), or of a module
    (``{parameter name: spec}``)."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return tree_map(lambda p: fsdp_spec(p, mesh, axis, min_size), params)


def fsdp_shard(module: torch.nn.Module, mesh: Mesh, axis: str = "data",
               min_size: int = 2 ** 14) -> torch.nn.Module:
    """Shard ``module``'s parameters over ``axis`` by their specs with
    FSDP2's ``fully_shard`` (in place; returns the module).  Replicated
    parameters are ``ignored_params``; their gradients are averaged over
    the axis by a hook once accumulated.  Without a process group, or at
    one rank on the axis, the module stays as it is."""
    group = mesh.group(axis)
    if group_size(group) <= 1:
        return module
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    specs = fsdp_specs(module, mesh, axis, min_size)
    params = dict(module.named_parameters())
    dims = {id(params[k]): s.index(axis) for k, s in specs.items() if s}
    whole = {params[k] for k, s in specs.items() if not s}
    n = group_size(group)

    def average(p):
        collectives.all_reduce(p.grad, group).div_(n)

    for p in whole:
        if p.requires_grad:
            p.register_post_accumulate_grad_hook(average)
    dm = mesh.device_mesh
    fully_shard(module, mesh=dm[axis] if dm.ndim > 1 else dm,
                shard_placement_fn=lambda p: Shard(dims[id(p)]),
                ignored_params=whole or None)
    return module


def zero_specs(opt_state, params, mesh: Mesh, axis: str = "data",
               min_size: int = 2 ** 14):
    """ZeRO: each optimizer-state array sharded as the parameter of its
    shape (moments mirror their parameters), everything else (step
    counters) replicated.  ``opt_state`` is any tree of arrays, e.g. a
    torch optimizer's ``state_dict()["state"]``."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    flat = {}
    for p in tree_leaves(params):
        flat.setdefault(_shape(p), fsdp_spec(p, mesh, axis, min_size))
    return tree_map(lambda x: flat.get(_shape(x), ()), opt_state)


class ZeroOptimizer:
    """An optimizer that holds its state only for this rank's shard of each
    parameter the specs shard (``zero_shard``).  ``step`` updates the
    shards from the gradients' shards (the gradients whole and the same on
    every rank, as after the data-parallel reduction), then gathers each
    parameter back whole."""

    def __init__(self, optimizer: torch.optim.Optimizer, mesh: Mesh, axis: str,
                 min_size: int):
        self.group = mesh.group(axis)
        n, r = group_size(self.group), group_rank(self.group)
        self.slots = []          # (parameter, its shard or itself, dim or None)
        groups = []
        for g in optimizer.param_groups:
            shards = []
            for p in g["params"]:
                spec = fsdp_spec(p, mesh, axis, min_size)
                if spec:
                    d = spec.index(axis)
                    k = p.shape[d] // n
                    s = torch.nn.Parameter(p.detach().narrow(d, r * k, k).clone())
                    self.slots.append((p, s, d))
                    shards.append(s)
                else:
                    self.slots.append((p, p, None))
                    shards.append(p)
            groups.append(dict(g, params=shards))
        self.inner = type(optimizer)(groups, **optimizer.defaults)
        self.param_groups = self.inner.param_groups
        self.state = self.inner.state

    def zero_grad(self, set_to_none: bool = True):
        for p, s, d in self.slots:
            p.grad = None if set_to_none else (p.grad.zero_() if p.grad is not None
                                               else None)
            if d is not None:
                s.grad = None
        self.inner.zero_grad(set_to_none)

    @torch.no_grad()
    def step(self):
        n, r = group_size(self.group), group_rank(self.group)
        for p, s, d in self.slots:
            if d is not None and p.grad is not None:
                k = p.shape[d] // n
                s.grad = p.grad.narrow(d, r * k, k).contiguous()
        out = self.inner.step()
        for p, s, d in self.slots:
            if d is not None:
                p.copy_(gather_rows(s.detach(), self.group, d))
        return out


def zero_shard(optimizer: torch.optim.Optimizer, mesh: Mesh, axis: str = "data",
               min_size: int = 2 ** 14):
    """ZeRO-1: ``optimizer`` (no step taken yet) rebuilt over this rank's
    shards of the parameters ``fsdp_specs`` shards, its state sharded as
    ``zero_specs`` says.  Without a process group, or at one rank on the
    axis, the optimizer itself."""
    if group_size(mesh.group(axis)) <= 1:
        return optimizer
    return ZeroOptimizer(optimizer, mesh, axis, min_size)


def separate_group_specs(param_groups: dict, mesh: Mesh,
                         shard_axes: Optional[dict] = None):
    """Separate sharding per optimizer group (a GAN's generator and
    discriminator): ``param_groups`` maps a name to its params tree,
    ``shard_axes`` a name to a mesh axis (None replicates the group)."""
    shard_axes = shard_axes or {}
    out = {}
    for name, params in param_groups.items():
        axis = shard_axes.get(name)
        if axis is None:
            out[name] = tree_map(lambda p: (), params)
        else:
            out[name] = fsdp_specs(params, mesh, axis)
    return out
