"""Spatial sharding of scene volumes over the ranks (port of
``deep3dmap_tpu/parallel/spatial.py``).

The recurrent global volume, and with it the ConvGRU's hidden state, is
split into slabs on its X axis, one per rank of the ``model`` axis.  TSDF
integration and the GRU's gates are voxel-local, so a slab needs its
neighbours only at its faces: each gate conv first swaps ``k // 2``
boundary slabs with the ranks on either side (``halo_pad``, one
``batch_isend_irecv``) and then runs VALID on X and SAME on Y/Z.  The rest
of the network runs replicated on every rank of the axis.

Where JAX's ``shard_map`` takes global arrays and splits them, these
functions take and return this rank's blocks, as the function inside the
``shard_map`` does; ``group`` is the ``model`` axis's process group
(``Mesh.group``), None for one rank.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.tsdf.fusion import TSDFParams, tsdf_integrate
from ..models.layers import _compute_dtype
from ..models.modulars.global_volume import GlobalVolumeState
from . import collectives
from .collectives import SumGradOver, gather_rows, group_rank, group_size
from .mesh import Mesh, replicate


def _active(mesh: Optional[Mesh], axis: Optional[str]) -> bool:
    return (mesh is not None and axis is not None and axis in mesh.axis_names
            and mesh.shape[axis] > 1)


def volume_sharding(mesh: Mesh, axis: str = "model",
                    batch_axis: Optional[str] = None) -> tuple:
    """The placement of (B, GX, GY, GZ, C) hidden volumes as JAX's
    ``PartitionSpec`` entries: GX over ``axis`` and B over ``batch_axis``
    where those axes have more than one rank; ``()`` replicated."""
    spatial = axis if _active(mesh, axis) else None
    batch = batch_axis if _active(mesh, batch_axis) else None
    if spatial is None and batch is None:
        return ()
    return (batch, spatial)


def shard_volume(v: torch.Tensor, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """This rank's X slab of a whole (B, G, G, G, C) volume (a volume whose
    X extent is already below its Y extent is a slab and stays)."""
    if not _active(mesh, axis) or v.shape[1] != v.shape[2]:
        return v.to(mesh.device)
    n, r = mesh.shape[axis], mesh.coordinate(axis)
    if v.shape[1] % n:
        raise ValueError(f"volume X={v.shape[1]} must divide over {n} ranks")
    k = v.shape[1] // n
    return v[:, r * k:(r + 1) * k].contiguous().to(mesh.device)


def shard_global_volumes(model_state, mesh: Mesh, axis: str = "model",
                         batch_axis: Optional[str] = None):
    """The recurrent global volumes (``global_hidden``) as this rank's X
    slabs; other model-state entries stay whole.  The batch dim is the
    rank's own already (its loader's), so ``batch_axis`` only names it."""
    out = {}
    for k, v in model_state.items():
        if k == "global_hidden":
            v = GlobalVolumeState(volumes=tuple(
                shard_volume(x, mesh, axis) if x.dim() == 5 else x.to(mesh.device)
                for x in v.volumes))
        out[k] = v
    return out


def gather_global_volumes(model_state, mesh: Mesh, axis: str = "model"):
    """The whole global volumes from this rank's X slabs (the inverse of
    ``shard_global_volumes``; every rank of ``axis`` takes part), as
    JAX's ``device_get`` gives them; other model-state entries stay."""
    if not _active(mesh, axis) or "global_hidden" not in model_state:
        return model_state
    group = mesh.group(axis)
    vols = tuple(gather_rows(v, group, 1) if v.dim() == 5 else v
                 for v in model_state["global_hidden"].volumes)
    return dict(model_state, global_hidden=GlobalVolumeState(volumes=vols))


def shard_train_state(state, mesh: Mesh, axis: Optional[str] = "model",
                      batch_axis: str = "data"):
    """A ``TrainState`` on the mesh: the network replicated from rank 0 (its
    optimizer has taken no step yet, so its state is the same everywhere),
    the global volumes sharded (``shard_global_volumes``) -- what
    ``BaseRunner.setup`` reaches when ``cfg.mesh`` has a ``model`` axis."""
    replicate(state.net, mesh)
    ms = (shard_global_volumes(state.model_state, mesh, axis, batch_axis)
          if axis is not None else state.model_state)
    return dataclasses.replace(state, model_state=ms)


def tsdf_fuse_frames_sharded(depth_ims, cam_intrs, cam_poses, origin,
                             params: TSDFParams, mesh: Mesh, axis: str = "x"):
    """TSDF fusion with the volume split on X over ``axis``: this rank
    integrates its slab of every frame, with the whole volume's voxel
    coordinates, and talks to no other rank.  Returns this rank's (tsdf,
    weight) slabs, each (X / n, Y, Z), equal to the unsharded fusion's rows."""
    n = mesh.shape.get(axis, 1)
    X = params.dim[0]
    assert X % n == 0, f"volume X={X} must divide over {n} devices"
    k = X // n
    x0 = mesh.coordinate(axis) * k
    slab = params._replace(dim=(k,) + tuple(params.dim[1:]))
    kw = dict(dtype=torch.float32, device=depth_ims.device)
    tsdf = torch.ones(slab.dim, **kw)
    weight = torch.zeros(slab.dim, **kw)
    for d, K, p in zip(depth_ims, cam_intrs, cam_poses):
        tsdf, weight = tsdf_integrate(tsdf, weight, d, K, p, origin, slab, x0=x0)
    return tsdf, weight


# ------------------------------------------------------- explicit halo SPMD
class _HaloPad(torch.autograd.Function):
    """(B, Xl, Y, Z, C) -> (B, Xl + 2 halo, Y, Z, C): the left neighbour's
    last ``halo`` slabs before, the right neighbour's first after, zeros at
    the ends.  The backward sends each halo's cotangent back to its owner
    and adds what comes back to the boundary slabs."""

    @staticmethod
    def forward(ctx, x, group, halo):
        ctx.group, ctx.halo = group, halo
        n, r = group_size(group), group_rank(group)
        if x.shape[1] < halo:
            raise ValueError(f"halo_pad: slab of {x.shape[1]} rows, halo {halo}")
        if halo == 0:
            return x.clone()
        first, last = x[:, :halo], x[:, -halo:]
        from_left = torch.zeros_like(first)
        from_right = torch.zeros_like(last)
        sends, recvs, slots = [], [], []
        if r + 1 < n:
            sends.append((last, r + 1))
            recvs.append((last, r + 1))
            slots.append("right")
        if r > 0:
            sends.append((first, r - 1))
            recvs.append((first, r - 1))
            slots.append("left")
        if n > 1:
            for slot, t in zip(slots, collectives.exchange(sends, recvs, group)):
                if slot == "right":
                    from_right = t
                else:
                    from_left = t
        return torch.cat([from_left, x, from_right], dim=1)

    @staticmethod
    def backward(ctx, g):
        group, h = ctx.group, ctx.halo
        n, r = group_size(group), group_rank(group)
        if h == 0:
            return g, None, None
        dx = g[:, h:-h].clone()
        sends, recvs, slots = [], [], []
        if r > 0:                      # my left halo is the left rank's last rows
            sends.append((g[:, :h], r - 1))
            recvs.append((g[:, :h], r - 1))
            slots.append("first")
        if r + 1 < n:
            sends.append((g[:, -h:], r + 1))
            recvs.append((g[:, -h:], r + 1))
            slots.append("last")
        if n > 1:
            for slot, t in zip(slots, collectives.exchange(sends, recvs, group)):
                if slot == "first":
                    dx[:, :h] += t
                else:
                    dx[:, -h:] += t
        return dx, None, None


def halo_pad(x: torch.Tensor, group, halo: int = 1) -> torch.Tensor:
    """Pad this rank's volume block (B, Xl, Y, Z, C) with ``halo`` slabs from
    its neighbours along ``group``; the ends receive zeros, as a global SAME
    padded conv sees them.  Differentiable."""
    return _HaloPad.apply(x, group, halo)


def _halo_conv3d(x_blk, conv, group):
    """The port's ``Conv`` (odd kernel) on an X-sharded block: halo on X,
    VALID there, SAME on Y/Z.  Its weight and bias get the sum of the
    ranks' gradients."""
    h = conv.kernel[0] // 2
    pad = halo_pad(x_blk, group, h)
    w, b = conv.weight, conv.bias
    if group_size(group) > 1 and torch.is_grad_enabled():
        w, b = SumGradOver.apply(w, group), SumGradOver.apply(b, group)
    dt = _compute_dtype(pad, w, conv.dtype)
    y = F.conv3d(pad.to(dt).movedim(-1, 1), w.to(dt), None,
                 padding=(0, h, h)).movedim(1, -1)
    return y + b.to(dt)


def conv_gru3d_halo(gru, h, x, mesh, axis: str = "model",
                    batch_axis: Optional[str] = None):
    """ConvGRU3D on this rank's X slabs of the hidden volume ``h`` (B, Xl,
    GY, GZ, Ch) and the input ``x`` (B, Xl, GY, GZ, Cx), with an explicit
    halo exchange before each gate conv; returns this rank's slab of the
    new hidden state.  ``gru`` is the port's ``ConvGRU3D`` (its ``convzr``
    and ``convq``; z and r share one fused conv); ``mesh`` a ``Mesh``
    whose ``axis`` carries the halos, or that axis's process group itself.
    The batch dim is the rank's own whatever ``batch_axis`` says.  Each
    gate conv sees its true neighbours, so the slabs put together equal
    the unsharded cell."""
    group = mesh.group(axis) if isinstance(mesh, Mesh) else mesh
    c = h.shape[-1]
    hx = torch.cat([h, x], dim=-1)
    zr = _halo_conv3d(hx, gru.convzr, group)
    z = torch.sigmoid(zr[..., :c])
    r = torch.sigmoid(zr[..., c:])
    rhx = torch.cat([r * h, x], dim=-1)
    q = torch.tanh(_halo_conv3d(rhx, gru.convq, group))
    return (1.0 - z) * h + z * q
