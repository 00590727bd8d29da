"""Patch samplers for GNeRF (port of
``deep3dmap_tpu/core/renderer/samples/patch_sampler.py``).

A sampler returns ``(coords, scales)``: coords (N, P, P, 2) in [-1, 1]² with
channel 0 along the image width, scales (N, 1, 1, 1).  ``FlexPatchSampler``
anneals its least scale with the iteration count, a device tensor, so no
step reads it back on the host; its random scale and shift come as tensors
(``draws``), drawn from a ``torch.Generator`` or fed from elsewhere.
"""
from __future__ import annotations

from typing import Optional

import torch

from ....ops.grid_sample import grid_sample_2d_batch


def _base_grid(patch_size: int, device) -> torch.Tensor:
    """(1, P, P, 2) grid over [-1, 1]²: channel 0 varies along the second
    axis (the width), channel 1 along the first."""
    lin = torch.linspace(-1.0, 1.0, patch_size, device=device)
    w, h = torch.meshgrid(lin, lin, indexing="ij")
    return torch.stack([h, w], dim=-1)[None]


class FullImageSampler:
    full_indices = True

    def __call__(self, nbatch: int, wh, device=None):
        W, H = wh[0], wh[1]
        lin_h = torch.linspace(-1.0, 1.0, W, device=device)
        lin_w = torch.linspace(-1.0, 1.0, H, device=device)
        w, h = torch.meshgrid(lin_w, lin_h, indexing="ij")
        coords = torch.stack([h, w], dim=-1)[None].expand(nbatch, H, W, 2)
        return coords, torch.ones((nbatch, 1, 1, 1), device=device)


class RescalePatchSampler:
    full_indices = False

    def __init__(self, scale: float = 1.0):
        self.scale = scale

    def __call__(self, nbatch: int, patch_size: int, device=None):
        coords = (_base_grid(patch_size, device) * self.scale).expand(
            nbatch, patch_size, patch_size, 2)
        return coords, torch.ones((nbatch, 1, 1, 1), device=device)


class FlexPatchSampler:
    full_indices = False

    def __init__(self, random_shift: bool = True, random_scale: bool = True,
                 min_scale: float = 0.25, max_scale: float = 1.0,
                 scale_anneal: float = -1.0):
        self.random_shift = random_shift
        self.random_scale = random_scale
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.scale_anneal = scale_anneal

    def current_scales(self, iterations: torch.Tensor):
        """(least, largest) scale at ``iterations`` (a device scalar)."""
        if self.scale_anneal > 0:
            decayed = self.max_scale * torch.exp(-iterations.float() * self.scale_anneal)
            return torch.clamp(torch.clamp(decayed, min=self.min_scale), max=0.8), \
                self.max_scale
        return self.min_scale, self.max_scale

    def draws(self, rng: Optional[torch.Generator], nbatch: int, device) -> dict:
        """The uniform draws of one call: ``scale``, ``h_off``, ``w_off``,
        each (N, 1, 1, 1), those the sampler's options use."""
        out = {}
        for key, on in (("scale", self.random_scale), ("h_off", self.random_shift),
                        ("w_off", self.random_shift)):
            if on:
                out[key] = torch.rand((nbatch, 1, 1, 1), generator=rng, device=device)
        return out

    def __call__(self, draws: dict, nbatch: int, patch_size: int,
                 iterations: torch.Tensor):
        device = iterations.device
        min_scale, max_scale = self.current_scales(iterations)
        grid = _base_grid(patch_size, device)
        if self.random_scale:
            scales = draws["scale"] * (max_scale - min_scale) + min_scale
        else:
            scales = torch.full((nbatch, 1, 1, 1), 1.0, device=device) * min_scale
        coords = grid * scales
        if self.random_shift:
            max_offset = 1.0 - scales
            h_off = (draws["h_off"] * 2 - 1) * max_offset
            w_off = (draws["w_off"] * 2 - 1) * max_offset
            coords = coords + torch.cat([h_off, w_off], dim=-1)
        return coords, scales


def sample_image_patches(imgs: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of (B, H, W, C) images at [-1, 1]² coords (B, P, P, 2)
    (``ops/grid_sample.py``: zero outside the image).  Returns (B, P, P, C)."""
    B, H, W, C = imgs.shape
    P = coords.shape[1]
    px = (coords[..., 0] + 1) * 0.5 * (W - 1)
    py = (coords[..., 1] + 1) * 0.5 * (H - 1)
    out = grid_sample_2d_batch(imgs, px.reshape(B, -1), py.reshape(B, -1))
    return out.reshape(B, P, P, C)
