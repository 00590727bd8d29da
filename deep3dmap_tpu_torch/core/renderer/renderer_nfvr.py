"""NeRF volume rendering: inverse-CDF importance sampling and compositing
(port of ``deep3dmap_tpu/core/renderer/renderer_nfvr.py``).

Plain PyTorch ops over one static ray batch: ``searchsorted``, ``cumsum``,
``cumprod`` and gathers.  The random numbers come in as tensors.
``sample_pdf`` runs without autograd (GNeRF's and LERF's MLP path stop its
gradient); ``sample_pdf_differentiable`` keeps it (LERF's hash-grid path).

The transmittance's ``cumprod`` has its own backward (``_CumprodNonzero``):
autograd's asks the device whether an input is zero before it picks its
formula, which makes every training step wait for the device.  Its
factors are 1 - alpha + 1e-10 > 0, so the backward is the zero-free case
of autograd's, the same arithmetic: a reversed cumulative sum of
grad x output, over the input.
"""
from __future__ import annotations

from typing import Optional

import torch


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Inverse-CDF samples of depth per ray.

    bins (N, M+1) bin edges, weights (N, M), u (N, K) in [0, 1): uniform
    draws, or ``linspace(0, 1, K)`` for the deterministic samples.  The
    result carries no gradient (JAX stops it where GNeRF uses it), so the
    function runs without autograd."""
    with torch.no_grad():
        return _sample_pdf(bins.detach(), weights.detach(), u, eps,
                           lambda x, i: torch.gather(x, 1, i))


def sample_pdf_differentiable(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor,
                              eps: float = 1e-5) -> torch.Tensor:
    """``sample_pdf`` with the gradient JAX's keeps where its caller does
    not stop it (LERF's proposal sampling): through the cdf and the bins to
    the weights, the cdf stopped only for ``searchsorted``.  The gathers are
    flat-row indexing, whose backward accumulates in a fixed order."""
    return _sample_pdf(bins, weights, u, eps, take_along_rows)


def _sample_pdf(bins, weights, u, eps, take):
    weights = weights + eps
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    m = weights.shape[1]
    inds = torch.searchsorted(cdf.detach().contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=m)
    cdf_g0, cdf_g1 = take(cdf, below), take(cdf, above)
    bins_g0, bins_g1 = take(bins, below), take(bins, above)
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_g0 + (u - cdf_g0) / denom * (bins_g1 - bins_g0)


def take_along_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx, axis=-1)`` for (N, M) ``x`` and in-range
    (N, K) ``idx``, as one flat-row gather: its backward is a sorted
    accumulation (a fixed order on the card), ``torch.gather``'s uses
    atomics."""
    n, m = x.shape
    base = torch.arange(n, device=x.device)[:, None] * m
    return x.reshape(-1)[base + idx]


class _CumprodNonzero(torch.autograd.Function):
    """``torch.cumprod`` along the last axis of a tensor with no zeros."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, -1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return torch.flip(torch.cumsum(torch.flip(out * grad, [-1]), -1), [-1]) / x


def volume_render(sigmas: torch.Tensor, rgbs: Optional[torch.Tensor], z_vals: torch.Tensor,
                  rays_d: torch.Tensor, far: torch.Tensor, white_back: bool = False,
                  noise: Optional[torch.Tensor] = None):
    """Composite densities and colours along rays.

    sigmas (N, S), rgbs (N, S, 3) or None, z_vals (N, S), rays_d (N, 3),
    far (N, 1); ``noise`` (N, S) is added to the densities (the caller
    scales it).  Returns (rgb (N, 3) or None, depth (N,), weights (N, S))."""
    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    deltas = torch.cat([deltas, far - z_vals[:, -1:]], -1)
    deltas = deltas * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if noise is not None:
        sigmas = sigmas + noise
    alphas = 1.0 - torch.exp(-deltas * torch.relu(sigmas))
    shifted = torch.cat([torch.ones_like(alphas[:, :1]), 1 - alphas + 1e-10], -1)
    T = _CumprodNonzero.apply(shifted)
    weights = alphas * T[:, :-1]
    depth = (weights * z_vals).sum(-1)
    if rgbs is None:
        return None, depth, weights
    rgb = (weights[..., None] * rgbs).sum(-2)
    if white_back:
        rgb = rgb + 1.0 - weights.sum(-1, keepdim=True)
    return rgb, depth, weights
