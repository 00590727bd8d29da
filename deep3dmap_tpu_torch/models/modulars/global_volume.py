"""Global hidden-state volumes with windowed read/write.

Port of ``deep3dmap_tpu/models/modulars/global_volume.py``.  Per scale, the
scene's recurrent GRU state lives in a fixed-size dense (B, G, G, G, C) array;
each fragment's window is addressed at its voxel offset from the scene
origin, rounded half to even (``torch.round`` and ``jnp.round`` agree) and
clamped into the extent.  When the window covers the whole extent (G ==
window) read and write are the identity / a full overwrite.  Windows at
other offsets are read and written with index tensors, so no start offset
travels to the host.

Sharded over the ranks of a ``model`` group (``parallel/spatial.py``), each
rank holds one X slab (B, G/n, G, G, C) of every volume.  A window's rows
then lie on the ranks that own them: ``read_windows_sharded`` has each rank
place the rows it owns in a zero window and one ``reduce_scatter`` sums the
windows into each rank's X slab of the window (only the owner's row is
non-zero, so the sum is exact); ``write_windows_sharded`` has each rank
take, from the whole new window that every rank of the group holds, the
rows that fall in its slab.  Where JAX leaves this to XLA's collective
permutes, the offsets stay on the device here too.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from ...parallel import collectives


class GlobalVolumeState(NamedTuple):
    """Per-scale hidden volumes, each (B, G, G, G, C)."""

    volumes: Tuple


def init_global_volumes(batch: int, global_dims: Sequence[int],
                        channels: Sequence[int], dtype=torch.float32,
                        device=None, x_split: int = 1) -> GlobalVolumeState:
    """Zero (B, G, G, G, C) volumes, or with ``x_split`` one rank's X slab
    (B, G / x_split, G, G, C) of each."""
    vols = tuple(torch.zeros((batch, g // x_split, g, g, c), dtype=dtype, device=device)
                 for g, c in zip(global_dims, channels))
    return GlobalVolumeState(volumes=vols)


def reset_volumes(state: GlobalVolumeState,
                  reset_mask: torch.Tensor) -> GlobalVolumeState:
    """Zero state for batch elements where reset_mask (B,) is True."""
    m = reset_mask.reshape(-1, 1, 1, 1, 1)
    vols = tuple(torch.where(m, torch.zeros_like(v), v) for v in state.volumes)
    return GlobalVolumeState(volumes=vols)


def _clamp_start(rel_origin_vox: torch.Tensor, global_dim: int,
                 window: int) -> torch.Tensor:
    start = torch.round(rel_origin_vox).to(torch.int64)
    return torch.clamp(start, 0, global_dim - window)


def _window_index(volume: torch.Tensor, rel_origin_vox: torch.Tensor,
                  window: int):
    """Advanced-index tuple selecting each sample's (window³) region."""
    B, g = volume.shape[0], volume.shape[1]
    start = _clamp_start(rel_origin_vox, g, window)              # (B, 3)
    r = torch.arange(window, device=volume.device)
    ix = start[:, 0, None] + r
    iy = start[:, 1, None] + r
    iz = start[:, 2, None] + r
    b = torch.arange(B, device=volume.device)
    return (b[:, None, None, None], ix[:, :, None, None],
            iy[:, None, :, None], iz[:, None, None, :])


def read_windows_batch(volume: torch.Tensor, rel_origin_vox: torch.Tensor,
                       window: int) -> torch.Tensor:
    """volume (B, G, G, G, C), rel_origin_vox (B, 3) -> (B, w, w, w, C)."""
    if volume.shape[1] == window:
        # window covers the whole extent: the clamp forces start 0
        return volume
    return volume[_window_index(volume, rel_origin_vox, window)]


def write_windows_batch(volume: torch.Tensor, window_data: torch.Tensor,
                        rel_origin_vox: torch.Tensor) -> torch.Tensor:
    """Returns a new volume with each sample's window overwritten (cast to
    the volume's dtype)."""
    w = window_data.shape[1]
    data = window_data.to(volume.dtype)
    if volume.shape[1] == w:
        return data
    out = volume.clone()
    out[_window_index(volume, rel_origin_vox, w)] = data
    return out


def read_window(volume: torch.Tensor, rel_origin_vox: torch.Tensor,
                window: int) -> torch.Tensor:
    """One sample's window: volume (G, G, G, C), rel_origin_vox (3,) ->
    (window, window, window, C)."""
    return read_windows_batch(volume[None], rel_origin_vox[None], window)[0]


def write_window(volume: torch.Tensor, window_data: torch.Tensor,
                 rel_origin_vox: torch.Tensor) -> torch.Tensor:
    """One sample's ``write_windows_batch``."""
    return write_windows_batch(volume[None], window_data[None], rel_origin_vox[None])[0]


def _slab_rows(volume: torch.Tensor, rel_origin_vox: torch.Tensor, window: int,
               global_dim: int, rank: int):
    """Per sample, for each of the window's X rows: its row in this rank's
    slab (clamped) and whether the slab holds it; and the window's Y/Z
    index tensors, as ``_window_index`` builds them."""
    B, gl = volume.shape[0], volume.shape[1]
    start = _clamp_start(rel_origin_vox, global_dim, window)         # (B, 3)
    r = torch.arange(window, device=volume.device)
    local = start[:, 0, None] + r - rank * gl                         # (B, w)
    held = (local >= 0) & (local < gl)
    iy = start[:, 1, None] + r
    iz = start[:, 2, None] + r
    return local.clamp(0, gl - 1), held, iy, iz


def read_windows_sharded(volume: torch.Tensor, rel_origin_vox: torch.Tensor,
                         window: int, group) -> torch.Tensor:
    """This rank's X slab (B, w/n, w, w, C) of each sample's window from an
    X-sharded volume: ``volume`` is this rank's slab (B, G/n, G, G, C) of
    the group's (B, G, G, G, C); one ``reduce_scatter`` over ``group``."""
    n, rank = collectives.group_size(group), collectives.group_rank(group)
    g = volume.shape[1] * n
    if g == window:
        return volume
    if window % n:
        raise ValueError(f"window {window} does not divide over {n} ranks")
    rows, held, iy, iz = _slab_rows(volume, rel_origin_vox, window, g, rank)
    b = torch.arange(volume.shape[0], device=volume.device)
    win = volume[b[:, None, None, None], rows[:, :, None, None],
                 iy[:, None, :, None], iz[:, None, None, :]]          # (B, w, w, w, C)
    win = win * held[:, :, None, None, None].to(win.dtype)
    part = collectives.reduce_scatter(win.transpose(0, 1), group)     # (w/n, B, ...)
    return part.transpose(0, 1).contiguous()


def write_windows_sharded(volume: torch.Tensor, window_data: torch.Tensor,
                          rel_origin_vox: torch.Tensor, group) -> torch.Tensor:
    """A new slab with each sample's window rows that this rank holds
    overwritten from ``window_data`` (B, w, w, w, C), the whole window,
    the same on every rank of ``group``; no communication."""
    n, rank = collectives.group_size(group), collectives.group_rank(group)
    w, gl = window_data.shape[1], volume.shape[1]
    data = window_data.to(volume.dtype)
    if gl * n == w:
        return data[:, rank * gl:(rank + 1) * gl].contiguous()
    B = volume.shape[0]
    start = _clamp_start(rel_origin_vox, gl * n, w)
    # for each slab row: the window row it takes, and whether it is in the window
    src = torch.arange(gl, device=volume.device) + rank * gl - start[:, 0, None]
    inside = (src >= 0) & (src < w)                                   # (B, gl)
    r = torch.arange(w, device=volume.device)
    iy = start[:, 1, None] + r
    iz = start[:, 2, None] + r
    b = torch.arange(B, device=volume.device)
    rows = torch.arange(gl, device=volume.device)
    idx = (b[:, None, None, None], rows[None, :, None, None],
           iy[:, None, :, None], iz[:, None, None, :])                # (B, gl, w, w)
    new = data[b[:, None], src.clamp(0, w - 1)]                       # (B, gl, w, w, C)
    out = volume.clone()
    out[idx] = torch.where(inside[:, :, None, None, None], new, volume[idx])
    return out
