"""Gan2Shape: unsupervised 3D shape from a 2D StyleGAN prior, step 1.

Port of ``deep3dmap_tpu/models/frameworks/gan2shape.py``, its step-1 forward
and inference: predict the canonical depth (mean-centred tanh, rescaled,
border-clamped), albedo, view (6-dof, scaled ranges) and light
(ambient/diffuse/direction); Lambertian shading; warp to the input view
through the depth renderer (``raster_mode="hard"`` runs the CUDA raster
kernel on the card); L1 + perceptual + smoothness losses.

Ported: ``photometric_loss``, ``smooth_loss``, the config parsing, the five
heads (so the JAX ``params`` tree loads whole), ``init``/``load_flax``,
``forward_step1`` and ``forward_test``.  Not ported yet (Gan2Shape
training): the StyleGAN2 generator and discriminator, ``latent_project``,
``gan_invert``, ``sample_pseudo_imgs``, steps 2 and 3, ``loss_fn``, the
parsing models (``parse_mask``) and loading ``gan_ckpt``.

Batches are dicts of numpy arrays or tensors with the JAX package's keys and
layouts: ``input_im`` (B, S, S, 3) in [-1, 1], optionally ``input_mask``
(B, S, S, 1).  Every step takes the device from the framework: CUDA unless
``device="cpu"`` was passed.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.renderer.renderer_nr import NrRenderer, get_transform_matrices
from ...utils.device import resolve_device
from ...utils.from_flax import load_flax_params
from ..backbones.encoder import Encoder
from ..backbones.encoder_decoder import EDDeconv
from ..layers import init_flax_defaults
from ..losses.perceptual_loss import PerceptualLoss
from .base import BaseFramework

_TEST_KEYS = ("depth", "albedo", "normal", "recon_im", "recon_depth")


def photometric_loss(pred, target, mask=None):
    """L1 with soft validity mask (reference utils.photometric_loss)."""
    loss = torch.abs(pred - target)
    if mask is not None:
        loss = loss * mask
        return loss.sum() / torch.clamp(mask.expand(loss.shape).sum(), min=1.0)
    return loss.mean()


def smooth_loss(x):
    """Total-variation smoothness; x (B, H, W) or (B, H, W, C)."""
    if x.ndim == 3:
        x = x[..., None]
    dx = torch.abs(x[:, :, 1:] - x[:, :, :-1]).mean()
    dy = torch.abs(x[:, 1:] - x[:, :-1]).mean()
    return dx + dy


class Gan2ShapeHeads(nn.Module):
    """The five heads, named as the JAX ``params`` tree's keys."""

    def __init__(self, image_size: int, nf: int, z_dim: int):
        super().__init__()
        self.depth_head = EDDeconv(image_size, cout=1, nf=nf)
        self.albedo_head = EDDeconv(image_size, cout=3, nf=nf)
        self.view_head = Encoder(cout=6, nf=nf)
        self.light_head = Encoder(cout=4, nf=nf)
        self.encoder_head = Encoder(cout=z_dim, nf=nf, activation="none")


class Gan2Shape(BaseFramework):
    def __init__(self, model_cfgs: dict, train_cfg=None, test_cfg=None,
                 device=None):
        cfg = dict(model_cfgs)
        for key in ("gan_ckpt", "parsing_ckpt"):
            if cfg.get(key):
                raise NotImplementedError(
                    f"Gan2Shape: {key} needs the StyleGAN2 / parsing models, "
                    "which are not ported yet (Gan2Shape training)")
        self.image_size = cfg.get("image_size", 64)
        self.gan_size = cfg.get("gan_size", self.image_size)
        self.z_dim = cfg.get("z_dim", 128)
        self.n_mlp = cfg.get("n_mlp", 8)
        self.channel_multiplier = cfg.get("channel_multiplier", 1)
        self.min_depth = cfg.get("min_depth", 0.9)
        self.max_depth = cfg.get("max_depth", 1.1)
        self.border_depth = cfg.get("border_depth",
                                    0.7 * self.max_depth + 0.3 * self.min_depth)
        self.xyz_rotation_range = cfg.get("xyz_rotation_range", 60)
        self.xy_translation_range = cfg.get("xy_translation_range", 0.1)
        self.z_translation_range = cfg.get("z_translation_range", 0.1)
        self.rand_light = cfg.get("rand_light", [-1, 1, -0.2, 0.8, -0.1, 0.6, -0.6])
        self.lam_perc = cfg.get("lam_perc", 1.0)
        self.lam_smooth = cfg.get("lam_smooth", 0.01)
        self.lam_regular = cfg.get("lam_regular", 0.01)
        self.batchsize = cfg.get("batchsize", 4)
        self.F1_d = cfg.get("F1_d", 2)
        self.view_scale = cfg.get("view_scale", 1.0)
        self.use_mask = cfg.get("use_mask", False)
        self.category = cfg.get("category", "face")
        self.test_cfg = test_cfg
        self.device = resolve_device(device)

        self.renderer = NrRenderer(cfg, self.image_size, device=self.device)
        nf = cfg.get("nf", 16)
        self.net = Gan2ShapeHeads(self.image_size, nf, self.z_dim).eval()
        self.perceptual = PerceptualLoss(seed=0, device=self.device)
        # border clamp of the canonical depth (gan2shape.py:195-197): the
        # two outermost columns on the W axis only, weight 1.02 (not 1.0)
        S = self.image_size
        self._border = F.pad(torch.zeros((1, S, S - 4), device=self.device),
                             (2, 2), value=1.02)

    def depth_rescaler(self, d):
        return (1 + d) / 2 * self.max_depth + (1 - d) / 2 * self.min_depth

    # -- weights -------------------------------------------------------------
    def init(self, seed: int, batch):
        """Seeded init of the heads mirroring flax's defaults (from an
        explicit ``torch.Generator``).  Returns (params, model_state): the
        heads module and an empty state (the frozen GAN is training's)."""
        init_flax_defaults(self.net, torch.Generator().manual_seed(int(seed)))
        self.net.to(self.device)
        return self.net, {}

    def load_flax(self, params: Mapping, perceptual_params: Optional[Mapping] = None):
        """Load a JAX ``Gan2Shape.init`` params tree (the five heads) and,
        when given, a ``PerceptualLoss.params`` tree; nested numpy arrays."""
        load_flax_params(self.net.cpu(), params)
        self.net.to(self.device)
        if perceptual_params is not None:
            self.perceptual.load_flax(perceptual_params)
        return self.net

    def batch_to_device(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        out = {}
        for k in ("input_im", "input_mask"):
            if k in batch:
                v = batch[k]
                v = torch.from_numpy(np.asarray(v)) if not torch.is_tensor(v) else v
                out[k] = v.to(self.device, torch.float32)
        return out

    # -- shared pieces -------------------------------------------------------
    def _view_trans(self, view):
        return torch.cat([
            view[:, :3] * math.pi / 180 * self.xyz_rotation_range,
            view[:, 3:5] * self.xy_translation_range,
            view[:, 5:] * self.z_translation_range], 1)

    def _light_terms(self, light):
        light_a = light[:, :1] / 2 + 0.5
        light_b = light[:, 1:2] / 2 + 0.5
        light_d = torch.cat([light[:, 2:], torch.ones_like(light[:, :1])], 1)
        light_d = light_d / torch.linalg.norm(light_d, dim=1, keepdim=True)
        return light_a, light_b, light_d

    def _predict_canonical(self, params, im):
        B = im.shape[0]
        depth_raw = params.depth_head(im)[..., 0]
        depth = depth_raw - depth_raw.reshape(B, -1).mean(1).reshape(B, 1, 1)
        depth = self.depth_rescaler(torch.tanh(depth))
        depth = depth * (1 - self._border) + self._border * self.border_depth
        albedo = params.albedo_head(im)
        view = params.view_head(im) * self.view_scale
        light = params.light_head(im)
        return depth, albedo, view, light

    def _shade(self, albedo, normal, light_a, light_b, light_d):
        diffuse = torch.clamp((normal * light_d[:, None, None, :]).sum(-1), min=0.0)
        shading = light_a[:, None, None, :] + light_b[:, None, None, :] * diffuse[..., None]
        texture = (albedo / 2 + 0.5) * shading * 2 - 1
        return texture, diffuse

    def _step1(self, params, batch):
        """The step-1 forward; returns (outputs, recon_mask, diffuse)."""
        im = batch["input_im"]
        depth, albedo, view, light = self._predict_canonical(params, im)
        rot_mat, trans_xyz = get_transform_matrices(self._view_trans(view))
        light_a, light_b, light_d = self._light_terms(light)

        normal = self.renderer.get_normal_from_depth(depth)
        texture, diffuse = self._shade(albedo, normal, light_a, light_b, light_d)

        recon_depth = self.renderer.warp_canon_depth(depth, rot_mat, trans_xyz)
        grid_2d = self.renderer.get_inv_warped_2d_grid(recon_depth, rot_mat, trans_xyz)
        margin = (self.max_depth - self.min_depth) / 2
        recon_mask = (recon_depth < self.max_depth + margin).to(im.dtype).detach()[..., None]
        if self.use_mask and "input_mask" in batch:
            recon_mask = recon_mask * batch["input_mask"]
        recon_im = torch.clamp(self.renderer._grid_sample_images(texture, grid_2d), -1, 1)
        outputs = dict(depth=depth, albedo=albedo, view=view, light=light,
                       normal=normal, texture=texture, recon_im=recon_im,
                       recon_depth=recon_depth)
        return outputs, recon_mask, diffuse

    # -- step 1 --------------------------------------------------------------
    def forward_step1(self, params, model_state, batch, rng=None):
        """Returns (total loss, log dict, outputs) as the JAX step does;
        ``rng`` is unused there too."""
        batch = self.batch_to_device(batch)
        im = batch["input_im"]
        out, recon_mask, diffuse = self._step1(params, batch)
        recon_im = out["recon_im"]
        loss_l1 = photometric_loss(recon_im, im, recon_mask)
        loss_perc = self.perceptual(recon_im * recon_mask, im * recon_mask).mean()
        loss_sm = smooth_loss(out["depth"]) + smooth_loss(diffuse)
        total = loss_l1 + self.lam_perc * loss_perc + self.lam_smooth * loss_sm
        log = dict(loss_l1=loss_l1, loss_perc=loss_perc, loss_smooth=loss_sm)
        return total, log, out

    def forward_test(self, params, model_state, batch):
        """The step-1 outputs the JAX ``forward_test`` returns.  JAX runs the
        whole ``forward_step1`` and drops its losses; here the losses (and
        their two VGG passes) are not computed."""
        with torch.no_grad():
            out, _, _ = self._step1(params, self.batch_to_device(batch))
        return {k: out[k] for k in _TEST_KEYS}, model_state
