"""Differentiable augmentation (DiffAugment, Zhao et al. 2020) on NHWC
batches (port of ``deep3dmap_tpu/models/function_utils/diff_augment.py``):
colour (brightness, saturation, contrast), translation by up to 1/8 of the
side with zero fill, and a cutout of half the side.

The draws come as tensors (``augment_draws``): ``brightness``,
``saturation``, ``contrast`` (B, 1, 1, 1) uniform, ``ty``/``tx`` (B, 1, 1)
integer shifts in [-s, s], ``oy``/``ox`` (B, 1, 1) integer cutout centres.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def _shift(side: int, ratio: float) -> int:
    return int(side * ratio + 0.5)


def augment_draws(rng: Optional[torch.Generator], shape, policy, device) -> dict:
    """The draws ``diff_augment`` reads for a batch of ``shape`` (B, H, W, C)."""
    B, H, W, _ = shape
    out = {}
    for p in _policy(policy):
        if p == "color":
            for k in ("brightness", "saturation", "contrast"):
                out[k] = torch.rand((B, 1, 1, 1), generator=rng, device=device)
        elif p == "translation":
            sh, sw = _shift(H, 0.125), _shift(W, 0.125)
            out["ty"] = torch.randint(-sh, sh + 1, (B, 1, 1), generator=rng, device=device)
            out["tx"] = torch.randint(-sw, sw + 1, (B, 1, 1), generator=rng, device=device)
        elif p == "cutout":
            ch, cw = _shift(H, 0.5), _shift(W, 0.5)
            out["oy"] = torch.randint(0, H + (1 - ch % 2), (B, 1, 1), generator=rng,
                                      device=device)
            out["ox"] = torch.randint(0, W + (1 - cw % 2), (B, 1, 1), generator=rng,
                                      device=device)
        else:
            raise KeyError(f"diff_augment: unknown policy {p!r}")
    return out


def _policy(policy) -> Sequence[str]:
    if not policy:
        return ()
    return policy.split(",") if isinstance(policy, str) else tuple(policy)


def _translation(x: torch.Tensor, ty: torch.Tensor, tx: torch.Tensor) -> torch.Tensor:
    B, H, W, _ = x.shape
    dev = x.device
    gy = torch.clamp(torch.arange(H, device=dev)[None, :, None] + ty + 1, 0, H + 1)
    gx = torch.clamp(torch.arange(W, device=dev)[None, None, :] + tx + 1, 0, W + 1)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return xp[torch.arange(B, device=dev)[:, None, None], gy, gx]


def _cutout(x: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor) -> torch.Tensor:
    _, H, W, _ = x.shape
    ch, cw = _shift(H, 0.5), _shift(W, 0.5)
    gy = torch.arange(H, device=x.device)[None, :, None]
    gx = torch.arange(W, device=x.device)[None, None, :]
    keep = ((gy < oy - ch // 2) | (gy >= oy + (ch + 1) // 2)
            | (gx < ox - cw // 2) | (gx >= ox + (cw + 1) // 2))
    return x * keep[..., None].to(x.dtype)


def diff_augment(x: torch.Tensor, draws: dict, policy=None) -> torch.Tensor:
    """x (B, H, W, C); ``policy`` an iterable of (or a comma-separated string
    of) ``color``, ``translation``, ``cutout``, applied in that order."""
    for p in _policy(policy):
        if p == "color":
            x = x + (draws["brightness"] - 0.5)
            mean = x.mean(dim=-1, keepdim=True)
            x = (x - mean) * (draws["saturation"] * 2) + mean
            mean = x.mean(dim=(1, 2, 3), keepdim=True)
            x = (x - mean) * (draws["contrast"] + 0.5) + mean
        elif p == "translation":
            x = _translation(x, draws["ty"], draws["tx"])
        elif p == "cutout":
            x = _cutout(x, draws["oy"], draws["ox"])
        else:
            raise KeyError(f"diff_augment: unknown policy {p!r}")
    return x
