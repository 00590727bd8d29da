"""LERF: a language-embedded radiance field (port of
``deep3dmap_tpu/models/frameworks/lerf.py``).

An RGB radiance field and a multi-scale language field supervised by the
CLIP pyramid and DINO targets of ``datasets/lerf_rays.py``, trained by
``IterBasedRunner``; at inference, relevancy maximised over scales.

- RGB field ``mlp``: the NeRF MLP with uniform and inverse-CDF samples
  (the samples carry no gradient, as in JAX; the coarse pass, whose only
  use is those samples, runs without autograd).  ``hashgrid``: nerfacto's
  hash-grid field behind a proposal density field, the main samples drawn
  from the proposal histogram WITH their gradient
  (``sample_pdf_differentiable``; JAX does not stop it), sorted, and the
  interlevel loss.
- The language field takes the ``num_lerf_samples`` highest-weight samples
  per ray.  ``jax.lax.top_k`` puts the lower index first among equal
  weights (early in training many weights are exactly 0); a stable
  descending sort keeps that rule on every device.
- Random numbers come in as tensors: ``draws(rng, n_rays)`` draws the
  proposal jitter and the inverse-CDF uniforms from a ``torch.Generator``
  (the runner's ``state.rng``), ``loss_fn(..., draws=)`` takes them from
  elsewhere (the tests feed JAX's).  ``forward_test`` renders the
  deterministic samples.
- ``get_max_across`` keeps each phrase's best relevancy and scale on the
  device (``torch.where`` on the maxima), so ``forward_test`` never waits
  for the device; JAX reads each maximum on the host.  The first scale is
  always taken and a later one only when its maximum is strictly larger,
  as in JAX.

On a mesh (``set_mesh``) every rank takes the same global batch of rays
and keeps its slice (the runner's ``shard_batch(global_batch=True)``),
draws the global batch's uniforms and keeps its slice, and takes every
mean over the global batch (``parallel/collectives.py``): two ranks then
equal one rank on the global batch.

``init`` returns ``LERFNet``, whose children are JAX's param collections
(``rgb_field``, ``lerf_field``, ``proposal``), so weights and Adam moments
carry across by name (``utils/from_flax.py``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ...core.renderer.renderer_lerf import render_clip, render_mean
from ...core.renderer.renderer_nfvr import (sample_pdf, sample_pdf_differentiable,
                                            take_along_rows, volume_render)
from ...parallel.collectives import global_mean, group_size, rank_slice
from ...utils.device import DeviceLike, resolve_device
from ..backbones.nerf import NeRF
from ..builder import RECONSTRUCTORS
from ..layers import init_flax_defaults
from ..modulars.clip_encoder import CLIPEncoder
from ..modulars.hash_nerf import (HashNerfField, ProposalDensityField, interlevel_loss,
                                  weights_from_sigmas)
from ..modulars.lerf_field import LERFField
from .base import BaseFramework


def linspace01(stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(0, stop, num)`` in float32 as XLA on the CPU computes it
    (``iota * (1 / div)``, then ``stop * step``, the last entry ``stop``);
    ``torch.linspace`` differs from it in the last bit."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) * float(1.0 / np.float32(div))
    return torch.cat([step * float(np.float32(stop)),
                      torch.full((1,), stop, dtype=torch.float32, device=device)])


class LERFNet(nn.Module):
    """JAX's param collections as children: ``rgb_field``, ``lerf_field`` and,
    for the hash-grid RGB field, ``proposal``."""

    def __init__(self, rgb_field, lerf_field, proposal=None):
        super().__init__()
        self.rgb_field, self.lerf_field = rgb_field, lerf_field
        if proposal is not None:
            self.proposal = proposal


@RECONSTRUCTORS.register_module(name=["LERF", "LERFModel"])
class LERFModel(BaseFramework):
    """``device``: where the net, the rays and the draws live (CUDA unless
    ``"cpu"``; raises without a GPU)."""

    def __init__(self, model_cfgs: dict, train_cfg=None, test_cfg=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        cfg = dict(model_cfgs)
        self.clip_n_dims = cfg.get("clip_n_dims", 512)
        self.dino_n_dims = cfg.get("dino_n_dims", 384)
        self.n_samples = cfg.get("N_samples", 32)
        self.n_importance = cfg.get("N_importance", 32)
        self.num_lerf_samples = cfg.get("num_lerf_samples", 12)
        self.max_scale = cfg.get("max_scale", 2.0)
        self.n_scales = cfg.get("n_scales", 8)
        self.scene_scale = cfg.get("scene_scale", 4.0)
        self.near = cfg.get("near", 0.5)
        self.far = cfg.get("far", 4.0)
        self.clip_loss_weight = cfg.get("clip_loss_weight", 0.5)
        self.dino_loss_weight = cfg.get("dino_loss_weight", 1.0)
        self.rgb_field_type = cfg.get("rgb_field_type", "mlp")
        if self.rgb_field_type == "hashgrid":
            self.rgb_field_cfg = dict(
                n_levels=cfg.get("rgb_grid_levels", 8),
                features_per_level=cfg.get("rgb_grid_features", 4),
                log2_hashmap_size=cfg.get("rgb_grid_log2", 16),
                base_res=cfg.get("rgb_grid_base", 16), end_res=cfg.get("rgb_grid_end", 256),
                hidden=cfg.get("rgb_hidden", 64))
            self.proposal_cfg = dict(log2_hashmap_size=cfg.get("prop_grid_log2", 14),
                                     end_res=cfg.get("prop_grid_end", 64))
            self.n_prop_samples = cfg.get("N_proposal", 48)
            self.interlevel_mult = cfg.get("interlevel_loss_mult", 1.0)
        else:
            self.rgb_field_cfg = dict(fc_depth=cfg.get("fc_depth", 4), fc_dim=cfg.get("fc_dim", 128))
        self.lerf_field_cfg = dict(
            grid_layers=tuple(cfg.get("grid_layers", (4, 4))),
            grid_sizes=tuple(cfg.get("grid_sizes", (14, 14))),
            grid_resolutions=tuple(tuple(r) for r in cfg.get("grid_resolutions",
                                                             ((16, 64), (64, 128)))),
            clip_n_dims=self.clip_n_dims, dino_n_dims=self.dino_n_dims,
            hidden=cfg.get("hidden", 128))
        self.image_encoder = CLIPEncoder(embed_dim=self.clip_n_dims,
                                         weights_path=cfg.get("clip_weights"),
                                         device=self.device)
        self.loss_group = None

    def set_mesh(self, mesh) -> bool:
        """The rays' draws and means go over the mesh's ``data`` axis."""
        self.loss_group = mesh.group("data")
        return False

    # -- framework contract ----------------------------------------------------
    def init(self, seed: int, batch):
        """Seeded weights with flax's initialisers (draws from a CPU
        ``torch.Generator``) on the framework's device; the model state is
        empty.  Returns (net, {})."""
        gen = torch.Generator().manual_seed(int(seed))
        if self.rgb_field_type == "hashgrid":
            net = LERFNet(HashNerfField(**self.rgb_field_cfg), LERFField(**self.lerf_field_cfg),
                          ProposalDensityField(**self.proposal_cfg))
        else:
            net = LERFNet(NeRF(**self.rgb_field_cfg), LERFField(**self.lerf_field_cfg))
        init_flax_defaults(net, gen)
        return net.to(self.device), {}

    def draws(self, rng: Optional[torch.Generator], n_rays: int, device=None) -> dict:
        """The uniforms of one training render of ``n_rays`` rays: ``u_pdf``
        (the inverse-CDF samples) and, for the hash-grid field, ``u_prop``
        (the proposal samples' jitter)."""
        dev = self.device if device is None else device
        out = {"u_pdf": torch.rand((n_rays, self.n_importance), generator=rng, device=dev)}
        if self.rgb_field_type == "hashgrid":
            out["u_prop"] = torch.rand((n_rays, self.n_prop_samples), generator=rng, device=dev)
        return out

    def _batch(self, batch) -> dict:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def _positions01(self, xyz: torch.Tensor) -> torch.Tensor:
        return torch.clamp((xyz + self.scene_scale / 2) / self.scene_scale, 0.0, 1.0)

    # -- rendering -------------------------------------------------------------
    def _render_rays_hash(self, net, rays_o, rays_d, draws, perturb):
        N = rays_o.shape[0]
        near = torch.full((N, 1), self.near, device=rays_o.device)
        far = torch.full((N, 1), self.far, device=rays_o.device)
        P, K = self.n_prop_samples, self.n_importance
        edges = near + (far - near) * linspace01(1.0, P + 1, rays_o.device)
        u = (draws["u_prop"] if perturb > 0
             else torch.full((N, P), 0.5, device=rays_o.device))
        z_prop = edges[:, :-1] + (edges[:, 1:] - edges[:, :-1]) * u
        xyz_p = rays_o[:, None] + rays_d[:, None] * z_prop[..., None]
        w_prop = weights_from_sigmas(net.proposal(self._positions01(xyz_p)), z_prop)
        u_pdf = (draws["u_pdf"] if perturb > 0
                 else linspace01(1.0, K, rays_o.device).expand(N, K))
        z_all = torch.sort(sample_pdf_differentiable(edges, w_prop + 1e-5, u_pdf), -1).values
        xyz = rays_o[:, None] + rays_d[:, None] * z_all[..., None]
        dirs = rays_d[:, None].expand(N, z_all.shape[1], 3)
        rgbs, sigmas = net.rgb_field(self._positions01(xyz), dirs)
        rgb, depth, weights = volume_render(sigmas, rgbs, z_all, rays_d, far)
        mid = 0.5 * (z_all[:, :-1] + z_all[:, 1:])
        t_final = torch.cat([z_all[:, :1], mid, z_all[:, -1:]], -1)
        prop_loss = interlevel_loss(edges, w_prop, t_final, weights, self.loss_group)
        return rgb, depth, weights, z_all, xyz, {"prop_loss": prop_loss}

    def _render_rays(self, net, rays_o, rays_d, draws, perturb: float = 1.0):
        if self.rgb_field_type == "hashgrid":
            return self._render_rays_hash(net, rays_o, rays_d, draws, perturb)
        N = rays_o.shape[0]
        near = torch.full((N, 1), self.near, device=rays_o.device)
        far = torch.full((N, 1), self.far, device=rays_o.device)
        z_steps = linspace01(1.0, self.n_samples, rays_o.device)
        z_vals = near * (1 - z_steps) + far * z_steps

        def field(z):
            xyz = rays_o[:, None] + rays_d[:, None] * z[..., None]
            S = xyz.shape[1]
            dirs = rays_d[:, None].expand(N, S, 3)
            out = net.rgb_field(xyz.reshape(-1, 3), dirs.reshape(-1, 3)).reshape(N, S, 4)
            return out[..., :3], out[..., 3], xyz

        with torch.no_grad():       # the coarse pass only places the samples
            rgbs, sigmas, _ = field(z_vals)
            _, _, weights_c = volume_render(sigmas, rgbs, z_vals, rays_d, far)
        K = self.n_importance
        u_pdf = (draws["u_pdf"] if perturb > 0
                 else linspace01(1.0, K, rays_o.device).expand(N, K))
        z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        new_z = sample_pdf(z_mid, weights_c[:, 1:-1], u_pdf)
        z_all = torch.sort(torch.cat([z_vals, new_z], -1), -1).values
        rgbs, sigmas, xyz = field(z_all)
        rgb, depth, weights = volume_render(sigmas, rgbs, z_all, rays_d, far)
        return rgb, depth, weights, z_all, xyz, {}

    def _lerf_samples(self, weights, z_all, xyz):
        """The ``num_lerf_samples`` highest-weight samples per ray, the lower
        index first among equal weights: (weights (detached), xyz, z)."""
        N, S = weights.shape
        ids = torch.sort(weights.detach(), stable=True, dim=-1, descending=True).indices
        ids = ids[:, :self.num_lerf_samples]
        w_top = take_along_rows(weights.detach(), ids)
        rows = torch.arange(N, device=ids.device)[:, None] * S + ids
        return w_top, xyz.reshape(N * S, 3)[rows], take_along_rows(z_all, ids)

    def loss_fn(self, net, model_state, batch, rng: Optional[torch.Generator] = None,
                draws: Optional[dict] = None):
        """(total loss, {"log_vars", "model_state"}); ``draws`` (``draws()``'s
        layout) replaces the draws from ``rng``."""
        b = self._batch(batch)
        g = self.loss_group
        if draws is None:
            draws = rank_slice(self.draws(rng, b["rays_o"].shape[0] * group_size(g)), g)
        rgb, depth, weights, z_all, xyz, raux = self._render_rays(
            net, b["rays_o"], b["rays_d"], draws)
        rgb_loss = global_mean((rgb - b["rgb"]) ** 2, g)
        w_top, xyz_top, z_top = self._lerf_samples(weights, z_all, xyz)
        scales = (b["clip_scales"][:, None] * z_top)[..., None]
        field_out = net.lerf_field(self._positions01(xyz_top.detach()), scales)
        clip_render = render_clip(field_out["clip"], w_top[..., None])
        dino_render = render_mean(field_out["dino"], w_top[..., None])
        clip_loss = global_mean((clip_render - b["clip"]).abs(), g) * self.clip_loss_weight
        dino_loss = global_mean((dino_render - b["dino"]) ** 2, g) * self.dino_loss_weight
        total = rgb_loss + clip_loss + dino_loss
        log_vars = {"rgb_loss": rgb_loss, "clip_loss": clip_loss, "dino_loss": dino_loss}
        if "prop_loss" in raux:
            total = total + self.interlevel_mult * raux["prop_loss"]
            log_vars["prop_loss"] = raux["prop_loss"]
        return total, {"log_vars": log_vars, "model_state": model_state}

    @torch.no_grad()
    def get_max_across(self, net, weights, hashgrid_feats,
                       preset_scales: Optional[Sequence[float]] = None):
        """Relevancy maximised over scales: (relevancy (phrases, ...), best
        scale per phrase), kept on the device."""
        n_phrases = len(self.image_encoder.positives)
        dev = hashgrid_feats.device
        scales = (torch.tensor(list(preset_scales), dtype=torch.float32, device=dev)
                  if preset_scales is not None
                  else linspace01(self.max_scale, self.n_scales, dev))
        best, best_max, best_scale = [None] * n_phrases, [None] * n_phrases, [None] * n_phrases
        for k in range(scales.shape[0]):
            s = scales[k]
            sc = s.expand(*hashgrid_feats.shape[:-1], 1)
            emb = render_clip(net.lerf_field.clip_from_hashgrid(hashgrid_feats, sc),
                              weights[..., None])
            for i in range(n_phrases):
                pos = self.image_encoder.get_relevancy(emb, i)[..., 0]
                m = pos.max()
                if k == 0:
                    best[i], best_max[i], best_scale[i] = pos, m, s
                    continue
                take = m > best_max[i]
                best[i] = torch.where(take, pos, best[i])
                best_max[i] = torch.where(take, m, best_max[i])
                best_scale[i] = torch.where(take, s, best_scale[i])
        return torch.stack(best), torch.stack(best_scale)

    @torch.no_grad()
    def forward_test(self, net, model_state, batch):
        """Deterministic render of the batch's rays (``rgb``, ``depth``) and,
        with positives set, ``raw_relevancy`` and ``best_scales``."""
        b = self._batch(batch)
        rgb, depth, weights, z_all, xyz, _ = self._render_rays(
            net, b["rays_o"], b["rays_d"], None, perturb=0.0)
        out = {"rgb": rgb, "depth": depth}
        if self.image_encoder.positives:
            w_top, xyz_top, _ = self._lerf_samples(weights, z_all, xyz)
            feats = net.lerf_field.hashgrid_features(self._positions01(xyz_top))
            out["raw_relevancy"], out["best_scales"] = self.get_max_across(net, w_top, feats)
        return out, model_state
