"""GNeRF's renderer: a coarse NeRF pass at stratified depths, then a fine
pass at the coarse depths and inverse-CDF importance samples (port of
``deep3dmap_tpu/models/modulars/gnerf.py``).

The random numbers of a call come in ``draws`` (``render_draws``):
``perturb`` (N, S) uniform jitter of the coarse depths, ``pdf_u`` (N, K)
uniform importance draws, ``noise_c`` (N, S) and ``noise_f`` (N, S + K)
standard normal density noise, scaled by ``noise_std``.  Without
``perturb`` the depths are the stratified ones and the importance samples
deterministic (``linspace``), as JAX's ``perturb=0``; without noise the
densities are the MLP's.  The fine depths carry no gradient; they are
concatenated to the coarse ones and sorted (stable).  Colours come out in
[-1, 1].
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ...core.renderer.renderer_nfvr import sample_pdf, volume_render
from ..backbones.nerf import NeRF


def render_draws(rng: Optional[torch.Generator], n_rays: int, n_samples: int,
                 n_importance: int, device) -> dict:
    """The draws of one stochastic render of ``n_rays`` rays."""
    S, K = n_samples, n_importance

    def u(*shape):
        return torch.rand(shape, generator=rng, device=device)

    def g(*shape):
        return torch.randn(shape, generator=rng, device=device)
    return dict(perturb=u(n_rays, S), noise_c=g(n_rays, S), pdf_u=u(n_rays, K),
                noise_f=g(n_rays, S + K))


class GNeRFRender(nn.Module):
    def __init__(self, xyz_freq: int = 10, dir_freq: int = 4, fc_depth: int = 8,
                 fc_dim: int = 256, skips=(4,), n_samples: int = 64,
                 n_importance: int = 64, white_back: bool = False):
        super().__init__()
        self.n_samples, self.n_importance = n_samples, n_importance
        self.white_back = white_back
        self.nerf = NeRF(xyz_freq, dir_freq, fc_depth, fc_dim, skips)

    def forward(self, rays: torch.Tensor, draws: Optional[dict] = None,
                perturb: float = 1.0, noise_std=0.0):
        """rays (N, 8) = [o, d, near, far].  Returns ``{"coarse", "fine"}``,
        each ``{"rgb" (N, 3) in [-1, 1], "depth" (N,), "opacity" (N,)}``;
        depth and opacity carry no gradient."""
        draws = draws or {}
        N = rays.shape[0]
        rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
        near, far = rays[:, 6:7], rays[:, 7:8]
        z_steps = torch.linspace(0.0, 1.0, self.n_samples, device=rays.device)
        z_vals = near * (1 - z_steps) + far * z_steps
        stochastic = "perturb" in draws and perturb > 0
        if stochastic:
            mids = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
            upper = torch.cat([mids, z_vals[:, -1:]], -1)
            lower = torch.cat([z_vals[:, :1], mids], -1)
            z_vals = lower + (upper - lower) * draws["perturb"] * perturb

        results, weights = {}, None
        for name in ("coarse", "fine"):
            if name == "fine":
                z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
                u = (draws["pdf_u"] if stochastic else
                     torch.linspace(0.0, 1.0, self.n_importance, device=rays.device)
                     .expand(N, self.n_importance))
                new_z = sample_pdf(z_mid, weights[:, 1:-1], u)
                z_vals, _ = torch.sort(torch.cat([z_vals, new_z], -1), dim=-1, stable=True)
            xyz = rays_o[:, None] + rays_d[:, None] * z_vals[..., None]
            S = xyz.shape[1]
            dirs = rays_d[:, None].expand(N, S, 3)
            out = self.nerf(xyz.reshape(-1, 3), dirs.reshape(-1, 3)).reshape(N, S, 4)
            noise = draws.get("noise_c" if name == "coarse" else "noise_f")
            rgb, depth, weights = volume_render(
                out[..., 3], out[..., :3], z_vals, rays_d, far, white_back=self.white_back,
                noise=None if noise is None else noise * noise_std)
            results[name] = {"rgb": rgb * 2.0 - 1.0, "depth": depth.detach(),
                             "opacity": weights.sum(-1).detach()}
        return results
