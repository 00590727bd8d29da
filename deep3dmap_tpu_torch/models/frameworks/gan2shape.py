"""Gan2Shape: unsupervised 3D shape from a 2D StyleGAN prior.

Port of ``deep3dmap_tpu/models/frameworks/gan2shape.py``: per-instance
fitting of depth/albedo/view/light heads against a frozen StyleGAN2.

- step 1: predict the canonical depth (mean-centred tanh, rescaled,
  border-clamped), albedo, view (6-dof, scaled ranges) and light
  (ambient/diffuse/direction); Lambertian shading; warp to the input view
  through the depth renderer (``raster_mode="hard"`` runs the CUDA raster
  kernel on the card); L1 + perceptual + smoothness losses.
- step 2: render ``batchsize`` pseudo images of the current canonical
  estimate under random views and lights (no gradient), project them into
  the StyleGAN latent space through the encoder head (a hidden-space offset
  through the split mapping net), reconstruct with the frozen generator;
  L1 + discriminator-feature + latent-norm losses.
- step 3: step 1 on the input plus the projected samples re-rendered under
  their predicted views and lights.

``parse_mask`` derives the region mask from the parsing models
(``models/parsing``, ``parsing_ckpt``).  ``init`` builds the five heads and the frozen
generator and discriminator (StyleGAN2's initializers, or ``gan_ckpt``, the
``.npz`` that ``tools/import_weights.py`` writes); ``load_flax`` carries a
JAX ``init``'s trees across.  ``params`` is the heads module; ``model_state``
holds the GAN modules (``gan_params``, ``disc_params``, named as JAX's
trees) and the mapping net's centres at z = 0 (``center_w``, ``center_h``).

Batches are dicts of numpy arrays or tensors with the JAX package's keys and
layouts: ``input_im`` (B, S, S, 3) in [-1, 1], optionally ``input_mask``
(B, S, S, 1); step 2 adds ``latent_w`` and the canonical ``depth``,
``albedo``, ``normal``, ``light``; step 3 ``proj_im`` and ``proj_mask``.
Random draws come from a ``torch.Generator`` on the framework's device.
Every step takes the device from the framework: CUDA unless
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
from ...ops.resize import resize_bilinear
from ...utils.device import resolve_device
from ...utils.from_flax import load_flax_params
from ..backbones.encoder import Encoder
from ..backbones.encoder_decoder import EDDeconv
from ..builder import RECONSTRUCTORS
from ..layers import init_flax_defaults
from ..losses.perceptual_loss import DiscriminatorLoss, PerceptualLoss
from ..modulars.stylegan2 import Generator, StyleDiscriminator, init_stylegan2
from ..parsing import FaceParser, SceneParser
from .base import BaseFramework

_TEST_KEYS = ("depth", "albedo", "normal", "recon_im", "recon_depth")
_BATCH_KEYS = ("input_im", "input_mask", "latent_w", "depth", "albedo",
               "normal", "light", "proj_im", "proj_mask")
_DRAW_KEYS = ("dxy", "rand", "views")


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


@RECONSTRUCTORS.register_module()
class Gan2Shape(BaseFramework):
    def __init__(self, model_cfgs: dict, train_cfg=None, test_cfg=None,
                 device=None):
        cfg = dict(model_cfgs)
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
        # the parsing model's .npz (``tools/import_weights.py bisenet``);
        # seeded weights without it
        self.parsing_ckpt = cfg.get("parsing_ckpt")
        self._parser = None
        self.gan_ckpt = cfg.get("gan_ckpt")
        self.mode = "step1"
        self.test_cfg = test_cfg
        self.device = resolve_device(device)

        self.renderer = NrRenderer(cfg, self.image_size, device=self.device)
        nf = cfg.get("nf", 16)
        self.net = Gan2ShapeHeads(self.image_size, nf, self.z_dim).eval()
        self.network_names = ["depth_head", "albedo_head", "view_head",
                              "light_head", "encoder_head"]
        # the frozen GAN: no parameter of it trains, gradients still flow
        # through it to its inputs
        self.generator = Generator(size=self.gan_size, style_dim=self.z_dim,
                                   n_mlp=self.n_mlp,
                                   channel_multiplier=self.channel_multiplier,
                                   device=self.device).requires_grad_(False).eval()
        self.discriminator = StyleDiscriminator(
            size=self.gan_size, channel_multiplier=self.channel_multiplier,
            device=self.device).requires_grad_(False).eval()
        self.center_w = self.center_h = None
        self.perceptual = PerceptualLoss(seed=0, device=self.device)
        self.d_loss = DiscriminatorLoss(ftr_num=cfg.get("ftr_num", 4))
        # border clamp of the canonical depth (gan2shape.py:195-197): the
        # two outermost columns on the W axis only, weight 1.02 (not 1.0)
        S = self.image_size
        self._border = F.pad(torch.zeros((1, S, S - 4), device=self.device),
                             (2, 2), value=1.02)

    def depth_rescaler(self, d):
        return (1 + d) / 2 * self.max_depth + (1 - d) / 2 * self.min_depth

    def parse_mask(self, images):
        """The category's region mask from the parsing model, built once:
        BiSeNet face parsing for ``face``/``synface``, PSPNet scene parsing
        otherwise (150 ADE classes for ``church``, 21 VOC classes else).
        ``images`` (B, S, S, 3) in [-1, 1], numpy or a tensor; returns the
        (B, image_size, image_size, 1) soft mask on the framework's device."""
        if self._parser is None:
            if self.category in ("face", "synface"):
                self._parser = FaceParser(self.parsing_ckpt, device=self.device)
            else:
                n_classes = 150 if self.category == "church" else 21
                self._parser = SceneParser(self.parsing_ckpt, n_classes=n_classes,
                                           device=self.device)
        return self._parser.parse_mask(self._on_device(images), self.category,
                                       out_size=self.image_size)

    def set_mode(self, mode: str):
        if mode not in ("step1", "step2", "step3"):
            raise ValueError(f"Gan2Shape: unknown mode {mode!r}")
        self.mode = mode

    # -- weights -------------------------------------------------------------
    def init(self, seed: int, batch):
        """Seeded weights from one CPU ``torch.Generator``: the heads with
        flax's defaults, then the generator and the discriminator with
        StyleGAN2's initializers (both replaced by ``gan_ckpt`` when it is
        set).  Returns (params, model_state): the heads and ``gan_state()``."""
        gen = torch.Generator().manual_seed(int(seed))
        init_flax_defaults(self.net, gen)
        self.net.to(self.device)
        init_stylegan2(self.generator, gen)
        init_stylegan2(self.discriminator, gen)
        if self.gan_ckpt:
            loaded = np.load(self.gan_ckpt, allow_pickle=True)
            self._load_gan(loaded["g"].item(), loaded["d"].item())
        with torch.no_grad():
            z = torch.zeros((1, self.z_dim), device=self.device)
            self.center_w = self.generator.mapping(z)
            self.center_h = self.generator.mapping(z, depth=self.n_mlp - self.F1_d)
        return self.net, self.gan_state()

    def _load_gan(self, g_params: Mapping, d_params: Mapping) -> None:
        """Flax-layout generator and discriminator trees (nested arrays)."""
        for module, tree in ((self.generator, g_params), (self.discriminator, d_params)):
            load_flax_params(module.cpu(), tree)
            module.to(self.device)

    def gan_state(self) -> Dict:
        """The model state the steps read, with JAX's keys."""
        return {"gan_params": self.generator, "disc_params": self.discriminator,
                "center_w": self.center_w, "center_h": self.center_h}

    def load_flax(self, params: Mapping, perceptual_params: Optional[Mapping] = None,
                  model_state: Optional[Mapping] = None):
        """Load a JAX ``Gan2Shape.init`` params tree (the five heads), when
        given a ``PerceptualLoss.params`` tree, and when given JAX's
        ``model_state`` its ``gan_params``, ``disc_params`` and centres
        (then read by ``gan_state()``); nested numpy arrays.  Returns the
        heads."""
        load_flax_params(self.net.cpu(), params)
        self.net.to(self.device)
        if perceptual_params is not None:
            self.perceptual.load_flax(perceptual_params)
        if model_state is not None:
            self._load_gan(model_state["gan_params"], model_state["disc_params"])
            self.center_w, self.center_h = (self._on_device(model_state[k])
                                            for k in ("center_w", "center_h"))
        return self.net

    def _on_device(self, v) -> torch.Tensor:
        """A numpy array or tensor as float32 on the framework's device."""
        v = v if torch.is_tensor(v) else torch.from_numpy(np.array(v, np.float32))
        return v.to(self.device, torch.float32)

    def batch_to_device(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        return {k: self._on_device(batch[k]) for k in _BATCH_KEYS if k in batch}

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

    def _render(self, texture, depth, rot_mat, trans_xyz):
        """Warp the canonical depth to the view, sample the texture through
        the inverse warp; returns (recon_im, recon_depth, recon_mask)."""
        recon_depth = self.renderer.warp_canon_depth(depth, rot_mat, trans_xyz)
        grid_2d = self.renderer.get_inv_warped_2d_grid(recon_depth, rot_mat, trans_xyz)
        margin = (self.max_depth - self.min_depth) / 2
        recon_mask = (recon_depth < self.max_depth + margin).to(texture.dtype).detach()[..., None]
        recon_im = torch.clamp(self.renderer._grid_sample_images(texture, grid_2d), -1, 1)
        return recon_im, recon_depth, recon_mask

    def _step1(self, params, batch):
        """The step-1 forward; returns (outputs, recon_mask, diffuse)."""
        im = batch["input_im"]
        depth, albedo, view, light = self._predict_canonical(params, im)
        rot_mat, trans_xyz = get_transform_matrices(self._view_trans(view))
        light_a, light_b, light_d = self._light_terms(light)

        normal = self.renderer.get_normal_from_depth(depth)
        texture, diffuse = self._shade(albedo, normal, light_a, light_b, light_d)
        recon_im, recon_depth, recon_mask = self._render(texture, depth, rot_mat, trans_xyz)
        if self.use_mask and "input_mask" in batch:
            recon_mask = recon_mask * batch["input_mask"]
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

    # -- pseudo sampling (gan2shape.py:246-272) ------------------------------
    def pseudo_draws(self, rng: torch.Generator, b: int) -> Dict[str, torch.Tensor]:
        """``sample_pseudo_imgs``' random draws from ``rng``, uniform in
        JAX's ranges: light directions ``dxy`` (b, 2), the shading offset
        ``rand`` (b, 1, 1, 1) and ``views`` (b, 6) in [-1, 1]."""
        x_min, x_max, y_min, y_max, dmin, dmax, _ = self.rand_light

        def u(shape, lo, hi):
            return torch.rand(shape, generator=rng, device=self.device) * (hi - lo) + lo
        return dict(dxy=torch.stack([u((b,), x_min, x_max), u((b,), y_min, y_max)], -1),
                    rand=u((b, 1, 1, 1), dmin, dmax), views=u((b, 6), -1.0, 1.0))

    def sample_pseudo_imgs(self, rng: Optional[torch.Generator], canon: Mapping,
                           batchsize: int, draws: Optional[Mapping] = None):
        """``batchsize`` renders of instance 0's canonical estimate (``canon``:
        depth, albedo, normal, light) under random lights and views; the
        draws from ``rng`` or, given, ``draws`` (``pseudo_draws``' keys).
        Returns (pseudo_im in [-1, 1], its mask), as JAX's under no grad."""
        b, S = batchsize, self.image_size
        alpha = self.rand_light[6]
        if draws is None:
            draws = self.pseudo_draws(rng, b)
        dxy, rand, views = (self._on_device(draws[k]) for k in _DRAW_KEYS)
        light_d = torch.cat([dxy, dxy.new_ones((b, 1))], 1)
        light_d = light_d / torch.linalg.norm(light_d, dim=1, keepdim=True)

        normal0 = canon["normal"][:1]
        light_a, light_b, _ = self._light_terms(canon["light"][:1])
        diffuse = torch.clamp((normal0 * light_d[:, None, None, :]).sum(-1), min=0.0)
        rand_diffuse = (light_b[0, 0] + rand) * diffuse[..., None]
        shading = light_a[0, 0] + alpha * rand + rand_diffuse
        pseudo = (canon["albedo"][:1] / 2 + 0.5) * shading * 2 - 1   # (b, S, S, 3)

        depth = canon["depth"][:1].expand(b, S, S)
        mask = pseudo.new_ones((b, S, S, 1))
        pseudo_im, mask = self.renderer.render_given_view(
            pseudo, depth, self._view_trans(views), mask=mask)
        return torch.clamp(pseudo_im, -1, 1), mask.detach()

    # -- latent projection (gan2shape.py:275-293) ----------------------------
    def latent_project(self, params, model_state, image, latent_w):
        offset = params.encoder_head(image)
        hidden = offset + model_state["center_h"]
        w = model_state["gan_params"].mapping(hidden, skip=self.n_mlp - self.F1_d)
        offset_w = w - model_state["center_w"]
        return offset_w, latent_w + offset_w

    def gan_invert(self, params, model_state, image, latent_w,
                   rng: Optional[torch.Generator]):
        offset, latent = self.latent_project(params, model_state, image, latent_w)
        gan_im = model_state["gan_params"](latent, input_is_latent=True, rng=rng)
        if self.gan_size != self.image_size:
            gan_im = resize_bilinear(gan_im, self.image_size)
        return torch.clamp(gan_im, -1, 1), offset

    def _rng(self, rng: Optional[torch.Generator]) -> torch.Generator:
        """JAX's ``loss_fn`` takes PRNGKey(0) without an rng; here a
        generator seeded 0 on the framework's device."""
        return torch.Generator(device=self.device).manual_seed(0) if rng is None else rng

    # -- step 2 --------------------------------------------------------------
    def forward_step2(self, params, model_state, batch, rng=None, draws=None):
        """``rng`` (a ``torch.Generator`` on the framework's device) draws
        the pseudo images' lights and views, then the generator's noise;
        ``draws`` replaces the former (``sample_pseudo_imgs``)."""
        batch = self.batch_to_device(batch)
        rng = self._rng(rng)
        canon = {k: batch[k] for k in ("depth", "albedo", "normal", "light")}
        with torch.no_grad():
            pseudo_im, mask = self.sample_pseudo_imgs(rng, canon, self.batchsize, draws)
        proj_im, offset = self.gan_invert(params, model_state, pseudo_im,
                                          batch["latent_w"], rng)
        loss_l1 = photometric_loss(proj_im, pseudo_im, mask)
        disc = model_state["disc_params"]

        def disc_features(x):
            if x.shape[1] != self.gan_size:
                x = resize_bilinear(x, self.gan_size)
            return disc.features(x, self.d_loss.ftr_num)

        loss_rec = self.d_loss(disc_features, proj_im, pseudo_im, mask=mask)
        loss_norm = torch.mean(offset ** 2)
        total = loss_l1 + loss_rec + self.lam_regular * loss_norm
        log = dict(loss_l1=loss_l1, loss_rec=loss_rec, loss_latent_norm=loss_norm)
        outputs = dict(proj_im=proj_im.detach(), mask=mask, pseudo_im=pseudo_im)
        return total, log, outputs

    # -- step 3 (gan2shape.py:323-352) ---------------------------------------
    def forward_step3(self, params, model_state, batch, rng=None):
        batch = self.batch_to_device(batch)
        total1, log1, out1 = self.forward_step1(params, model_state, batch, rng)
        proj_im, mask = batch["proj_im"], batch["proj_mask"]
        b, S = proj_im.shape[0], self.image_size

        view = params.view_head(proj_im)
        rot_mat, trans_xyz = get_transform_matrices(self._view_trans(view))
        light_a, light_b, light_d = self._light_terms(params.light_head(proj_im))
        # instance 0's canonical estimate under each sample's view and light
        normal = out1["normal"][:1].expand(b, S, S, 3)
        albedo = out1["albedo"][:1].expand(b, S, S, 3)
        texture, _ = self._shade(albedo, normal, light_a, light_b, light_d)
        depth = out1["depth"][:1].expand(b, S, S)
        recon_im, _, recon_mask = self._render(texture, depth, rot_mat, trans_xyz)
        recon_mask = recon_mask * mask

        loss_l1 = photometric_loss(recon_im, proj_im, recon_mask)
        loss_perc = self.perceptual(recon_im * recon_mask, proj_im * recon_mask).mean()
        total = total1 + loss_l1 + self.lam_perc * loss_perc
        log = dict(log1, step3_l1=loss_l1, step3_perc=loss_perc)
        return total, log, out1

    # -- framework contract --------------------------------------------------
    def loss_fn(self, params, model_state, batch, rng=None, mode: Optional[str] = None,
                draws=None):
        """(total, {"log_vars", "model_state"}) of ``mode`` (default: the
        framework's ``set_mode``), the heads in train mode.  ``draws`` is
        step 2's (``forward_step2``)."""
        mode = mode or self.mode
        params.train()
        if mode == "step1":
            total, log, _ = self.forward_step1(params, model_state, batch, rng)
        elif mode == "step2":
            total, log, _ = self.forward_step2(params, model_state, batch, rng, draws)
        elif mode == "step3":
            total, log, _ = self.forward_step3(params, model_state, batch, rng)
        else:
            raise ValueError(f"Gan2Shape: unknown mode {mode!r}")
        return total, {"log_vars": log, "model_state": model_state}

    def forward_test(self, params, model_state, batch):
        """The step-1 outputs the JAX ``forward_test`` returns (the runner's
        snapshot of the canonical estimate too).  JAX runs the whole
        ``forward_step1`` and drops its losses; here the losses (and their
        two VGG passes) are not computed."""
        params.eval()
        with torch.no_grad():
            out, _, _ = self._step1(params, self.batch_to_device(batch))
        return {k: out[k] for k in _TEST_KEYS}, model_state
