"""LERF's ray renderers (port of ``deep3dmap_tpu/core/renderer/renderer_lerf.py``):
weight-composited CLIP embeddings, L2-normalised, and the plain weighted
sum for DINO."""
from __future__ import annotations

import torch


def render_clip(embeds: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """embeds (..., S, D), weights (..., S, 1) -> (..., D) normalised; the
    1e-6 inside the sqrt keeps the gradient finite where the sum is 0."""
    out = (embeds * weights).sum(-2)
    return out / torch.sqrt((out ** 2).sum(-1, keepdim=True) + 1e-6)


def render_mean(embeds: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    return (embeds * weights).sum(-2)
