"""The hash-grid NeRF field and proposal sampling of LERF's ``hashgrid`` RGB
path (port of ``deep3dmap_tpu/models/modulars/hash_nerf.py``): nerfacto's
density/colour field over a hash grid, a small proposal density field,
alpha-compositing weights and the interlevel (proposal histogram) loss.

``trunc_exp`` is an autograd Function (JAX's ``custom_jvp``): exp forward,
its gradient taken at the input clipped to [-15, 15].  The transmittance's
``cumprod`` uses the renderer's ``_CumprodNonzero`` (its factors are
1 - alpha + 1e-10 > 0), whose backward does not ask the device for zeros.
``interlevel_loss``'s gathers are flat-row indexing (a sorted, fixed-order
accumulation in the backward), and its ``searchsorted`` takes JAX's
default side, ``"left"``.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ...core.renderer.renderer_nfvr import _CumprodNonzero, take_along_rows
from ...parallel.collectives import global_mean
from ..layers import Dense
from .hashgrid import HashGridEncoding


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.exp(torch.clamp(x, -15.0, 15.0)) * g


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp with a gradient-clamped input (instant-ngp's density activation)."""
    return _TruncExp.apply(x)


def posenc(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[sin(2^k x), cos(2^k x)] per frequency k, as JAX lays them out."""
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    ang = x[..., None, :] * freqs[:, None]
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
    return enc.reshape(*x.shape[:-1], -1)


class HashNerfField(nn.Module):
    """Density and colour over hash-grid features (nerfacto's main field);
    children named as flax's (``grid``, ``base1``, ..., ``color3``)."""

    def __init__(self, n_levels: int = 8, features_per_level: int = 4,
                 log2_hashmap_size: int = 16, base_res: int = 16, end_res: int = 256,
                 hidden: int = 64, geo_feat_dim: int = 15, dir_freq: int = 4):
        super().__init__()
        self.dir_freq = dir_freq
        self.grid = HashGridEncoding(n_levels, features_per_level, log2_hashmap_size,
                                     base_res, end_res)
        self.base1 = Dense(self.grid.out_dim, hidden)
        self.base2 = Dense(hidden, 1 + geo_feat_dim)
        self.color1 = Dense(geo_feat_dim + 6 * dir_freq, hidden)
        self.color2 = Dense(hidden, hidden)
        self.color3 = Dense(hidden, 3)

    def forward(self, xyz01: torch.Tensor, dirs: torch.Tensor):
        """xyz01 (..., 3) in [0, 1], dirs (..., 3) unit -> (rgb, sigma)."""
        h = self.base2(torch.relu(self.base1(self.grid(xyz01))))
        sigma = trunc_exp(h[..., 0])
        c = torch.cat([h[..., 1:], posenc(dirs, self.dir_freq)], -1)
        c = torch.relu(self.color2(torch.relu(self.color1(c))))
        return torch.sigmoid(self.color3(c)), sigma


class ProposalDensityField(nn.Module):
    """Density-only hash-grid field (nerfacto's proposal network)."""

    def __init__(self, n_levels: int = 5, features_per_level: int = 2,
                 log2_hashmap_size: int = 14, base_res: int = 16, end_res: int = 64,
                 hidden: int = 16):
        super().__init__()
        self.grid = HashGridEncoding(n_levels, features_per_level, log2_hashmap_size,
                                     base_res, end_res)
        self.d1 = Dense(self.grid.out_dim, hidden)
        self.d2 = Dense(hidden, 1)

    def forward(self, xyz01: torch.Tensor) -> torch.Tensor:
        return trunc_exp(self.d2(torch.relu(self.d1(self.grid(xyz01))))[..., 0])


def weights_from_sigmas(sigmas: torch.Tensor, z_vals: torch.Tensor) -> torch.Tensor:
    """Alpha-compositing weights over (N, S) samples; the last interval
    closes at 1e3."""
    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], 1e3)], -1)
    alpha = 1.0 - torch.exp(-sigmas * deltas)
    trans = _CumprodNonzero.apply(1.0 - alpha + 1e-10)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    return alpha * trans


def interlevel_loss(t_prop: torch.Tensor, w_prop: torch.Tensor, t_final: torch.Tensor,
                    w_final: torch.Tensor, group=None) -> torch.Tensor:
    """Nerfacto's proposal loss: the final weights' mass beyond the proposal
    histogram's measure over each final interval, squared over the final
    weight.  t_prop (N, P+1), w_prop (N, P), t_final (N, S+1), w_final (N, S).
    ``group``: the data-parallel ranks whose rays the mean covers."""
    cw = torch.cat([torch.zeros_like(w_prop[..., :1]), torch.cumsum(w_prop, -1)], -1)
    last = t_prop.shape[-1] - 2
    t_sorted = t_prop.detach().contiguous()

    def cum_at(t_query):
        idx = torch.searchsorted(t_sorted, t_query.detach().contiguous(), right=False)
        idx = torch.clamp(idx - 1, 0, last)
        t0, t1 = take_along_rows(t_prop, idx), take_along_rows(t_prop, idx + 1)
        c0, c1 = take_along_rows(cw, idx), take_along_rows(cw, idx + 1)
        f = torch.clamp((t_query - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)
        return c0 + (c1 - c0) * f

    w_outer = cum_at(t_final[..., 1:]) - cum_at(t_final[..., :-1])
    wf = w_final.detach()
    excess = torch.clamp(wf - w_outer, min=0.0)
    return global_mean(excess ** 2 / (wf + 1e-7), group)
