"""Global hidden-state volumes with windowed read/write.

Port of ``deep3dmap_tpu/models/modulars/global_volume.py``.  Per scale, the
scene's recurrent GRU state lives in a fixed-size dense (B, G, G, G, C) array;
each fragment's window is addressed at its voxel offset from the scene
origin, rounded half to even (``torch.round`` and ``jnp.round`` agree) and
clamped into the extent.  When the window covers the whole extent (G ==
window) read and write are the identity / a full overwrite.  Windows at
other offsets are read and written with index tensors, so no start offset
travels to the host.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch


class GlobalVolumeState(NamedTuple):
    """Per-scale hidden volumes, each (B, G, G, G, C)."""

    volumes: Tuple


def init_global_volumes(batch: int, global_dims: Sequence[int],
                        channels: Sequence[int], dtype=torch.float32,
                        device=None) -> GlobalVolumeState:
    vols = tuple(torch.zeros((batch, g, g, g, c), dtype=dtype, device=device)
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
