"""Block-sparse voxel volumes: fixed-capacity active 8³ blocks.

Port of ``deep3dmap_tpu/ops/block_sparse.py``.  A dim³ volume is cut into
(dim/bs)³ blocks of bs³ voxels; a fixed-capacity set of MAXB active blocks is
selected from a block mask, and block data moves between the dense
(B, d, d, d, C) layout and the blocked (B, MAXB, bs, bs, bs, C) layout with
row gathers and scatters of whole z-lines.  Convolutions run VALID on
halo-padded blocks (``gather_halo``), which reproduces the sparse conv's
neighbour lookup.  Layouts, orders and padding conventions are the JAX
package's, so block ids and slots agree exactly.

Selection (``first_nonzero``) compacts with a cumsum and a scatter instead
of ``torch.nonzero``: the result is the same (the first ``size`` active ids in
ascending linear order, padded with 0), and no step syncs with the host.
``select_blocks(..., count_as=name)`` counts each row's active blocks
against the budget (``utils/tracing.py``), and ``gather_halo`` records the
span ``block_sparse.gather_halo`` under a profiler.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from ..utils import tracing


class BlockSet(NamedTuple):
    """Active-block bookkeeping for one volume (batched).

    ids: (B, MAXB) int64 linear block ids into the (nb³) grid, padded with 0
        beyond the active count (masked by ``valid``).
    valid: (B, MAXB) bool, real block vs padding slot.
    slot_of: (B, nb³) int64 inverse map block id -> slot, -1 if inactive.
    nb: blocks per side.  bs: block side in voxels.
    """

    ids: torch.Tensor
    valid: torch.Tensor
    slot_of: torch.Tensor
    nb: int
    bs: int


def first_nonzero(mask: torch.Tensor, size: int):
    """Per row of a (B, N) bool mask: the first ``size`` True positions in
    ascending order, padded with 0, and the row's True count.

    Same result as ``jnp.nonzero(m, size=size, fill_value=0)``; ranks come
    from a cumsum and the positions are scattered into their rank, with every
    position past ``size`` routed to a dropped scratch column.
    """
    B, N = mask.shape
    m = mask.to(torch.int64)
    rank = torch.cumsum(m, dim=1) - 1
    keep = mask & (rank < size)
    dest = torch.where(keep, rank, torch.full_like(rank, size))
    pos = torch.arange(N, device=mask.device).expand(B, N)
    ids = torch.zeros((B, size + 1), dtype=torch.int64, device=mask.device)
    ids.scatter_(1, dest, pos)
    return ids[:, :size], m.sum(dim=1)


def select_blocks(block_mask: torch.Tensor, maxb: int, bs: int,
                  count_as: Optional[str] = None) -> BlockSet:
    """Pick up to ``maxb`` active blocks from a (B, nb, nb, nb) bool mask:
    the first ``maxb`` active ids in ascending linear order.  ``count_as``
    names the counter of each row's active blocks (budget ``maxb``)."""
    B, nb = block_mask.shape[0], block_mask.shape[1]
    dev = block_mask.device
    ids, n = first_nonzero(block_mask.reshape(B, nb ** 3), maxb)
    if count_as is not None:
        tracing.count(count_as, n, cap=maxb)
    valid = torch.arange(maxb, device=dev)[None, :] < n[:, None]
    # padding slots all carry id 0 -- route their writes to a scratch entry
    # so a real block 0 keeps its slot
    slot = torch.full((B, nb ** 3 + 1), -1, dtype=torch.int64, device=dev)
    safe = torch.where(valid, ids, torch.full_like(ids, nb ** 3))
    slot.scatter_(1, safe, torch.arange(maxb, device=dev).expand(B, maxb))
    return BlockSet(ids=ids, valid=valid, slot_of=slot[:, :-1], nb=int(nb),
                    bs=bs)


def block_mask_from_voxels(vox_mask: torch.Tensor, bs: int) -> torch.Tensor:
    """(B, d, d, d) voxel mask -> (B, nb, nb, nb) any-reduction block mask."""
    B, d = vox_mask.shape[0], vox_mask.shape[1]
    nb = d // bs
    m = vox_mask.reshape(B, nb, bs, nb, bs, nb, bs)
    return m.any(dim=6).any(dim=4).any(dim=2)


def _decode_ids(ids: torch.Tensor, nb: int):
    """Linear block ids -> (bx, by, bz) on the (nb)³ grid."""
    return ids // (nb * nb), (ids // nb) % nb, ids % nb


def _line_rows(bset: BlockSet) -> torch.Tensor:
    """Row of every contiguous z-line of the active blocks.

    The dense (B, d, d, d, C) volume flattens to (B, d*d*nb, bs*C) rows, one
    per (x, y, z-block) z-line.  Returns (B, MAXB*bs²) rows ordered
    (block, vx, vy), so the gathered rows reshape to (MAXB, bs, bs, bs, C).
    """
    nb, bs = bset.nb, bset.bs
    d = nb * bs
    bx, by, bz = _decode_ids(bset.ids, nb)                 # (B, MAXB)
    r = torch.arange(bs, device=bset.ids.device)
    vx, vy = torch.meshgrid(r, r, indexing="ij")
    vx, vy = vx.reshape(-1), vy.reshape(-1)                # (bs²,)
    gx = bx[..., None] * bs + vx
    gy = by[..., None] * bs + vy
    rows = (gx * d + gy) * nb + bz[..., None]
    return rows.reshape(rows.shape[0], -1)


def _batch_offsets(B: int, stride: int, device) -> torch.Tensor:
    return (torch.arange(B, device=device) * stride)[:, None]


def dense_to_blocks(vol: torch.Tensor, bset: BlockSet) -> torch.Tensor:
    """Gather active blocks: (B, d, d, d, C) -> (B, MAXB, bs, bs, bs, C)."""
    B, d, C = vol.shape[0], vol.shape[1], vol.shape[-1]
    nb, bs = bset.nb, bset.bs
    R = d * d * nb
    flat = vol.reshape(B * R, bs, C)
    rows = _line_rows(bset) + _batch_offsets(B, R, vol.device)
    # advanced indexing: padding slots repeat rows, and its backward adds
    # them in a fixed order on the card (index_select's uses atomics)
    g = flat[rows.reshape(-1)]
    return g.reshape(B, bset.ids.shape[1], bs, bs, bs, C)


def _scatter_lines(flat: torch.Tensor, blocks: torch.Tensor, bset: BlockSet,
                   R: int) -> torch.Tensor:
    """Write the blocks' z-lines into ``flat`` (B*R real rows followed by one
    scratch row per slot) and return the real rows.  Every slot gets a
    distinct row -- padding slots their own scratch row -- so the write is a
    deterministic unique-index copy."""
    B, maxb, bs = blocks.shape[0], blocks.shape[1], blocks.shape[2]
    C = blocks.shape[-1]
    n_slots = B * maxb * bs * bs
    rows = _line_rows(bset) + _batch_offsets(B, R, blocks.device)
    valid = bset.valid.repeat_interleave(bs * bs, dim=1)
    scratch = B * R + torch.arange(n_slots, device=blocks.device)
    safe = torch.where(valid.reshape(-1), rows.reshape(-1), scratch)
    vals = blocks.reshape(n_slots, bs * C).to(flat.dtype)
    flat.index_copy_(0, safe, vals)
    return flat[:B * R]


def blocks_to_dense(blocks: torch.Tensor, bset: BlockSet,
                    fill: float = 0.0) -> torch.Tensor:
    """Scatter active blocks into a ``fill``-initialised dense volume
    (padding slots dropped)."""
    B, maxb, bs = blocks.shape[0], blocks.shape[1], blocks.shape[2]
    C = blocks.shape[-1]
    d = bset.nb * bs
    R = d * d * bset.nb
    flat = torch.full((B * R + B * maxb * bs * bs, bs * C), fill,
                      dtype=blocks.dtype, device=blocks.device)
    return _scatter_lines(flat, blocks, bset, R).reshape(B, d, d, d, C)


def blocks_to_dense_over(blocks: torch.Tensor, bset: BlockSet,
                         base: torch.Tensor) -> torch.Tensor:
    """Scatter active blocks onto a copy of an existing dense volume:
    inactive blocks keep ``base``'s data (the reference GRU fusion updates
    only the current sparse set, gru_fusion.py:122-150)."""
    B, maxb, bs = blocks.shape[0], blocks.shape[1], blocks.shape[2]
    C = blocks.shape[-1]
    d = bset.nb * bs
    R = d * d * bset.nb
    flat = torch.cat([base.reshape(B * R, bs * C),
                      base.new_zeros((B * maxb * bs * bs, bs * C))], dim=0)
    return _scatter_lines(flat, blocks, bset, R).reshape(B, d, d, d, C)


def _take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-batch row gather: table (B, R, ...), idx (B, K) -> (B, K, ...)."""
    b = torch.arange(table.shape[0], device=table.device)[:, None]
    return table[b, idx]


def gather_halo(blocks: torch.Tensor, bset: BlockSet,
                halo: int = 1) -> torch.Tensor:
    """(B, MAXB, bs, bs, bs, C) -> (B, MAXB, bs+2h, bs+2h, bs+2h, C).

    Each active block's 27-neighbourhood (inactive neighbours and
    out-of-volume positions read zeros), cropped to the halo window.  The
    source is pre-sliced into the 3x3x3 slab categories a window consumes,
    each gathered with its own neighbour-slot table, so the gathered bytes
    are the window's, not 27 blocks'.
    """
    with tracing.span("block_sparse.gather_halo"):
        return _gather_halo(blocks, bset, halo)


def _gather_halo(blocks: torch.Tensor, bset: BlockSet, halo: int) -> torch.Tensor:
    B, maxb, bs = blocks.shape[0], blocks.shape[1], blocks.shape[2]
    nb = bset.nb
    if halo > bs:
        raise ValueError(f"halo {halo} > block size {bs}")
    bx, by, bz = _decode_ids(bset.ids, nb)

    def slot_for(dx, dy, dz):
        """Neighbour slot ids at offset (dx, dy, dz); -1 -> zeros."""
        nx, ny, nz = bx + dx, by + dy, bz + dz
        inb = ((nx >= 0) & (nx < nb) & (ny >= 0) & (ny < nb)
               & (nz >= 0) & (nz < nb))
        nid = ((nx.clamp(0, nb - 1) * nb + ny.clamp(0, nb - 1)) * nb
               + nz.clamp(0, nb - 1))
        ns = torch.gather(bset.slot_of, 1, nid)
        return torch.where(inb & bset.valid, ns, torch.full_like(ns, -1))

    # per-axis slab a window takes from the neighbour at offset d:
    #   d=-1 -> its last h voxels; d=0 -> all; d=+1 -> its first h
    sl = {-1: slice(bs - halo, bs), 0: slice(0, bs), 1: slice(0, halo)}

    def piece(dx, dy, dz):
        src = blocks[:, :, sl[dx], sl[dy], sl[dz], :]
        zero = src.new_zeros((B, 1) + src.shape[2:])
        table = torch.cat([src, zero], dim=1)              # (B, MAXB+1, ...)
        s = slot_for(dx, dy, dz)
        return _take_rows(table, torch.where(s >= 0, s, torch.full_like(s, maxb)))

    offs = (-1, 0, 1)
    xs = []
    for dx in offs:
        ys = []
        for dy in offs:
            ys.append(torch.cat([piece(dx, dy, dz) for dz in offs], dim=4))
        xs.append(torch.cat(ys, dim=3))
    return torch.cat(xs, dim=2)


def child_block_mask(occ_blocks: torch.Tensor,
                     parent_bset: BlockSet) -> torch.Tensor:
    """Child-level active-block mask from the parent's block occupancy.

    Child block (2px+ox, 2py+oy, 2pz+oz) on the 2nb grid is active iff
    octant (ox, oy, oz) of parent block (px, py, pz) holds an occupied voxel.
    occ_blocks: (B, MAXB, bs, bs, bs) bool.  Returns (B, 2nb, 2nb, 2nb) bool.
    """
    B, maxb, bs = occ_blocks.shape[0], occ_blocks.shape[1], occ_blocks.shape[2]
    nb = parent_bset.nb
    nb_c = nb * 2
    h = bs // 2
    octs = occ_blocks.reshape(B, maxb, 2, h, 2, h, 2, h)
    octs = octs.any(dim=7).any(dim=5).any(dim=3).reshape(B, maxb, 8)

    px, py, pz = _decode_ids(parent_bset.ids, nb)
    r = torch.arange(2, device=occ_blocks.device)
    ox, oy, oz = torch.meshgrid(r, r, r, indexing="ij")
    ox, oy, oz = ox.reshape(-1), oy.reshape(-1), oz.reshape(-1)   # (8,)
    cid = (((px[..., None] * 2 + ox) * nb_c + (py[..., None] * 2 + oy)) * nb_c
           + (pz[..., None] * 2 + oz))                             # (B, MAXB, 8)
    safe = torch.where(parent_bset.valid[..., None], cid,
                       torch.full_like(cid, nb_c ** 3)).reshape(B, -1)
    # any-reduction as an integer count (order-free, so deterministic)
    hits = torch.zeros((B, nb_c ** 3 + 1), dtype=torch.int32,
                       device=occ_blocks.device)
    hits.scatter_add_(1, safe, octs.reshape(B, -1).to(torch.int32))
    return (hits[:, :-1] > 0).reshape(B, nb_c, nb_c, nb_c)


def gather_parent_octants(parent_blocks: torch.Tensor, parent_bset: BlockSet,
                          child_bset: BlockSet,
                          fill: Union[torch.Tensor, float] = 0.0) -> torch.Tensor:
    """Per active child block, the (bs/2)³ parent region it refines, read
    straight from the parent's block slots (``fill`` where the parent block
    is inactive; a scalar or a (C,) vector).

    parent_blocks: (B, MAXB_p, bs, bs, bs, C).  Returns (B, MAXB_c, h, h, h, C).
    """
    B, maxb_p, bs = (parent_blocks.shape[0], parent_blocks.shape[1],
                     parent_blocks.shape[2])
    C = parent_blocks.shape[-1]
    nb = parent_bset.nb
    h = bs // 2
    # octant-sliced parent: (B, MAXB_p*8, h, h, h, C), octant = ox*4+oy*2+oz
    octs = parent_blocks.reshape(B, maxb_p, 2, h, 2, h, 2, h, C)
    octs = octs.permute(0, 1, 2, 4, 6, 3, 5, 7, 8)
    octs = octs.reshape(B, maxb_p * 8, h, h, h, C)
    fill_row = torch.as_tensor(fill, dtype=parent_blocks.dtype,
                               device=parent_blocks.device)
    fill_row = fill_row.expand(B, 1, h, h, h, C)
    table = torch.cat([octs, fill_row], dim=1)

    cx, cy, cz = _decode_ids(child_bset.ids, nb * 2)
    pid = ((cx // 2) * nb + (cy // 2)) * nb + (cz // 2)
    pslot = torch.gather(parent_bset.slot_of, 1, pid)      # -1 if inactive
    olin = (cx % 2) * 4 + (cy % 2) * 2 + (cz % 2)
    row = torch.where((pslot >= 0) & child_bset.valid, pslot * 8 + olin,
                      torch.full_like(pslot, maxb_p * 8))
    return _take_rows(table, row)


def block_voxel_indices(bset: BlockSet) -> torch.Tensor:
    """Linear voxel indices (x-major, as ``back_project._voxel_world_from_flat``
    reads them) of every voxel in the active blocks: (B, MAXB*bs³), padding
    slots pointing at block 0's voxels (mask with ``bset.valid``)."""
    nb, bs = bset.nb, bset.bs
    d = nb * bs
    bx, by, bz = _decode_ids(bset.ids, nb)
    r = torch.arange(bs, device=bset.ids.device)
    vx, vy, vz = torch.meshgrid(r, r, r, indexing="ij")
    vx, vy, vz = vx.reshape(-1), vy.reshape(-1), vz.reshape(-1)   # (bs³,)
    gx = bx[..., None] * bs + vx
    gy = by[..., None] * bs + vy
    gz = bz[..., None] * bs + vz
    idx = (gx * d + gy) * d + gz
    return idx.reshape(idx.shape[0], -1)
