"""Rank mesh and batch placement on ``torch.distributed`` (port of
``deep3dmap_tpu/parallel/mesh.py``).

One process per card.  ``make_mesh`` lays the ranks out on named axes with
JAX's names and shape rules and builds a ``DeviceMesh`` over them, whose
per-axis process groups carry the collectives (NCCL for CUDA tensors, gloo
for CPU tensors).  Without a process group the mesh is one rank with no
groups, and every path runs as on one card.

Axis conventions, as in the JAX package:
  - ``data``:  the batch / fragment axis (data parallelism);
  - ``model``: the spatial axis of the global TSDF volume (``spatial.py``).
"""
from __future__ import annotations

import functools
import os
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device


class Mesh:
    """Ranks on named axes: ``axis_names``, ``shape`` ({axis: size}, as
    ``jax.sharding.Mesh.shape``), the ``DeviceMesh`` (None without a
    process group) and ``device``, the card (or CPU) of this rank."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 device_mesh=None, device: Optional[torch.device] = None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.device_mesh = device_mesh
        self.device = device

    def group(self, axis: str):
        """The process group of ``axis`` (this rank's row along it), or None
        without a process group or without that axis."""
        if self.device_mesh is None or axis not in self.axis_names:
            return None
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 without a process group)."""
        if self.device_mesh is None or axis not in self.axis_names:
            return 0
        return self.device_mesh.get_local_rank(axis)


@dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh description, constructed from config."""

    axes: tuple = ("data",)
    shape: Optional[tuple] = None  # None -> every rank on the first axis

    def resolve(self, n_ranks: int) -> list:
        """The mesh shape over ``n_ranks`` ranks: ``None`` puts them all on
        the first axis, one ``-1`` takes what the others leave; a shape
        that needs more ranks raises ``ValueError``."""
        if self.shape is None:
            shape = [n_ranks] + [1] * (len(self.axes) - 1)
        else:
            shape = list(self.shape)
            if -1 in shape:
                known = int(np.prod([s for s in shape if s != -1]))
                shape[shape.index(-1)] = n_ranks // known
        n = int(np.prod(shape))
        if n > n_ranks:
            raise ValueError(f"mesh shape {shape} needs {n} devices, have {n_ranks}")
        return shape

    def build(self, device: DeviceLike = None) -> Mesh:
        initialized = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if initialized else 1
        shape = self.resolve(world)
        dev = _rank_device(device)
        if not initialized:
            return Mesh(self.axes, shape, None, dev)
        from torch.distributed.device_mesh import DeviceMesh

        n = int(np.prod(shape))
        dtype = "cuda" if dist.get_backend() == dist.Backend.NCCL else "cpu"
        dm = DeviceMesh(dtype, torch.arange(n).reshape(shape),
                        mesh_dim_names=tuple(self.axes))
        return Mesh(self.axes, shape, dm, dev)


def _rank_device(device: DeviceLike) -> torch.device:
    """``device`` as given, else this rank's card (``cuda:LOCAL_RANK`` as
    ``init_dist`` set it), or the CPU under a gloo group."""
    if device is not None:
        return resolve_device(device)
    if (dist.is_available() and dist.is_initialized()
            and dist.get_backend() == dist.Backend.GLOO):
        return torch.device("cpu")
    resolve_device(None)              # raises without a card
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(axes: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None,
              device: DeviceLike = None) -> Mesh:
    return MeshSpec(tuple(axes), tuple(shape) if shape is not None else None).build(device)


def init_dist(init_method: Optional[str] = None, world_size: Optional[int] = None,
              rank: Optional[int] = None, device: DeviceLike = None) -> None:
    """Start the process group from torchrun's environment (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or from the
    arguments; a no-op at one process.  On the card (the default) it sets
    this process's device to ``cuda:LOCAL_RANK`` and takes NCCL; with
    ``device="cpu"`` gloo."""
    world = int(world_size if world_size is not None else os.environ.get("WORLD_SIZE", 1))
    if world <= 1 or dist.is_initialized():
        return
    rank = int(rank if rank is not None else os.environ["RANK"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method or "env://",
                            world_size=world, rank=rank)


def get_dist_info() -> tuple:
    """(rank, world size) of ``torch.distributed``, or (0, 1) when it is
    not initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def master_only(func):
    """Run only on rank 0; other ranks get None."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if get_dist_info()[0] == 0:
            return func(*args, **kwargs)
        return None

    return wrapper


def data_spec(mesh: Mesh, axis: str = "data") -> tuple:
    """The leading (batch) dim sharded over ``axis``: JAX's
    ``PartitionSpec`` entries as a tuple, ``()`` for replicated."""
    return (axis,) if axis in mesh.axis_names else ()


def _numeric_leaf(v) -> bool:
    if isinstance(v, torch.Tensor):
        return True
    if isinstance(v, (bool, int, float, np.number, np.bool_)):
        return True
    return isinstance(v, np.ndarray) and v.dtype.kind in "bifuc"


def tree_leaves(v) -> list:
    """The leaves of nested dicts, lists and tuples."""
    if isinstance(v, Mapping):
        return [x for k in v for x in tree_leaves(v[k])]
    if isinstance(v, (list, tuple)):
        return [x for e in v for x in tree_leaves(e)]
    return [v]


def tree_map(fn, v):
    """``fn`` on every leaf of nested dicts, lists and tuples."""
    if isinstance(v, Mapping):
        return {k: tree_map(fn, x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(tree_map(fn, x) for x in v)
    return fn(v)


def shard_batch(batch, mesh: Optional[Mesh] = None, axis: str = "data",
                global_batch: bool = False, non_blocking: bool = False):
    """A host batch on this rank's device (``mesh.device``).

    Dict entries whose leaves are not all numeric (scene names, fragment
    ids) are dropped, as the JAX function drops them: the step cannot take
    them.  By default the batch is the rank's own, as each rank's loader
    yields it (``DistributedSampler``); ``global_batch=True`` takes a whole
    global batch and keeps this rank's slice of each leaf's leading dim,
    replicating scalars and leading dims that do not divide over ``axis``.
    float64 arrays arrive as float32, as JAX canonicalises them.  With
    ``non_blocking`` on the card the host copies are pinned first.
    """
    from ..datasets.builder import _host_tensor

    if isinstance(batch, dict):
        batch = {k: v for k, v in batch.items()
                 if tree_leaves(v) and all(_numeric_leaf(x) for x in tree_leaves(v))}
    mesh = mesh if mesh is not None else make_mesh()
    n = mesh.shape.get(axis, 1)
    r = mesh.coordinate(axis)
    dev = mesh.device

    pin = non_blocking and dev.type == "cuda"

    def put(x):
        t = _host_tensor(x)
        if global_batch and t.dim() > 0 and n > 1 and t.shape[0] % n == 0:
            k = t.shape[0] // n
            t = t[r * k:(r + 1) * k]
        if pin and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(dev, non_blocking=non_blocking)

    return tree_map(put, batch)


def replicate(tree, mesh: Optional[Mesh] = None):
    """Every rank's copy of ``tree`` (a module, a tensor, or dicts and lists
    of them) set to rank 0's, in place; tensors move to the mesh's device
    first.  Without a process group, only the move."""
    dev = mesh.device if mesh is not None else None
    on = dist.is_available() and dist.is_initialized()
    from . import collectives

    def put(x):
        if isinstance(x, torch.nn.Module):
            if on:
                with torch.no_grad():
                    for t in list(x.parameters()) + list(x.buffers()):
                        collectives.broadcast(t.data, 0)
            return x
        if not isinstance(x, torch.Tensor):
            return x
        x = x.to(dev) if dev is not None else x
        if on:
            x = x.contiguous()
            collectives.broadcast(x, 0)
        return x

    return tree_map(put, tree)
