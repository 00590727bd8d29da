"""GanNerf (GNeRF): pose-free NeRF trained adversarially, then refined
photometrically (port of ``deep3dmap_tpu/models/frameworks/gnerf.py``).

States and their optimize sequences (``StateMachineRunner``):

  A    : generator, discriminator, inversion net, train- and val-pose
         regularisation
  ABAB : A's sequences, then train- and val-pose refinement
  B    : train- and val-pose refinement

- ``generator_trainstep``: render patches at random poses on the spherical
  cap, fool D (non-saturating softplus loss); ``it`` += 1.
- ``discriminator_trainstep``: real patches (``FlexPatchSampler`` crops) vs
  the rendered ones, softplus GAN loss, DiffAugment inside D.
- ``inversion_net_trainstep``: the ViT regresses ``pose_to_d9`` of the
  random poses from rendered patches (MSE).
- ``training``/``val_pose_regularization``: each image's pose embedding
  toward the inversion net's prediction on its patch (MSE).
- ``training_refine_step``: NeRF and train poses, photometric MSE of coarse
  and fine renders against crops; ``val_refine_step``: val poses only.

The net (``init``) holds JAX's five top-level param collections as its
children: ``generator``, ``discriminator``, ``inv_net``, ``train_poses``,
``val_poses``, so ``StateMachineRunner`` keeps five Adams.  ``model_state``
is ``{"it": int32 scalar, "disc_stats": spectral-norm tree}``; the
generator and discriminator sequences update ``disc_stats``.

Random numbers: ``draws(rng, opt_seq, batch_size)`` draws every tensor a
sequence uses from a ``torch.Generator``; ``loss_fn(..., draws=)`` takes
them from elsewhere instead (the tests feed JAX's).  The noise level and
the patch-scale annealing are tensor functions of ``it``, so no step reads
the device.  Renders whose output JAX detaches (the discriminator's and the
inversion net's fakes) run under ``torch.no_grad()``: the same values and
gradients without the graph.  ``forward_test`` renders rays in chunks of
``RENDER_CHUNK``: a 400² view is 160,000 rays of 192 samples, whose
256-wide activations would take 31 GB each in one batch; the chunked
render is per ray (no jitter, no noise), so the numbers are those of one
batch.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.renderer.samples.patch_sampler import (FlexPatchSampler, FullImageSampler,
                                                    RescalePatchSampler,
                                                    sample_image_patches)
from ...core.renderer.samples.ray_sampler import RaySampler
from ...utils.device import DeviceLike, resolve_device
from ..builder import RECONSTRUCTORS
from ..layers import init_flax_defaults
from ..modulars.dynamic_patch_discriminator import Discriminator, disc_draws
from ..modulars.embeddings import PoseParameters, pose_to_d9, take_rows
from ..modulars.gnerf import GNeRFRender, render_draws
from ..modulars.inversion_net import InversionNet
from .base import BaseFramework

RENDER_CHUNK = 16384
SEQUENCES = {
    "A": ["generator_trainstep", "discriminator_trainstep", "inversion_net_trainstep",
          "training_pose_regularization", "val_pose_regularization"],
    "B": ["training_refine_step", "val_refine_step"],
}
SEQUENCES["ABAB"] = SEQUENCES["A"] + SEQUENCES["B"]
NETNAMES = {
    "generator_trainstep": ["generator"],
    "discriminator_trainstep": ["discriminator"],
    "inversion_net_trainstep": ["inv_net"],
    "training_pose_regularization": ["train_poses"],
    "val_pose_regularization": ["val_poses"],
    "training_refine_step": ["generator", "train_poses"],
    "val_refine_step": ["val_poses"],
}


class GanNerfNet(nn.Module):
    """The five param collections, children in JAX's order."""

    def __init__(self, generator, discriminator, inv_net, train_poses, val_poses):
        super().__init__()
        self.generator, self.discriminator, self.inv_net = generator, discriminator, inv_net
        self.train_poses, self.val_poses = train_poses, val_poses


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device) for v in tree]
    return (tree if torch.is_tensor(tree) else torch.from_numpy(np.array(tree))).to(device)


@RECONSTRUCTORS.register_module(name=["GanNerf", "gnerf"])
class GanNerf(BaseFramework):
    """``device``: where the net, the rays and the draws live (CUDA unless
    ``"cpu"`` is asked for)."""

    is_multi_opt_iters = True

    def __init__(self, model_cfgs: dict, train_cfg=None, test_cfg=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        cfg = dict(model_cfgs)
        self.img_wh = tuple(cfg.get("img_wh", (64, 64)))
        self.patch_size = cfg.get("patch_size", 16)
        self.inv_size = cfg.get("inv_size", 16)
        self.pose_mode = cfg.get("pose_mode", "6d")
        min_scale = cfg.get("min_scale", self.patch_size / max(self.img_wh[0], self.img_wh[1]))
        self.dynamic_patch_sampler = FlexPatchSampler(
            random_scale=cfg.get("random_scale", True), min_scale=min_scale,
            max_scale=cfg.get("max_scale", 1.0), scale_anneal=cfg.get("scale_anneal", 0.0002))
        self.static_patch_sampler = RescalePatchSampler()
        self.full_img_sampler = FullImageSampler()
        self.ray_sampler = RaySampler(
            near=cfg.get("near", 0.5), far=cfg.get("far", 4.0),
            azim_range=cfg.get("azim_range", (0.0, 360.0)),
            elev_range=cfg.get("elev_range", (0.0, 60.0)),
            radius=cfg.get("radius", (1.0, 1.5)),
            look_at_origin=cfg.get("look_at_origin", True), ndc=cfg.get("ndc", False),
            device=self.device)
        self.generator_cfg = dict(
            xyz_freq=cfg.get("xyz_freq", 10), dir_freq=cfg.get("dir_freq", 4),
            fc_depth=cfg.get("fc_depth", 8), fc_dim=cfg.get("fc_dim", 256),
            n_samples=cfg.get("N_samples", 64), n_importance=cfg.get("N_importance", 64),
            white_back=cfg.get("white_back", False))
        self.disc_cfg = dict(conditional=cfg.get("conditional", True),
                             policy=cfg.get("policy", ("color", "translation", "cutout")),
                             ndf=cfg.get("ndf", 64), imsize=self.patch_size)
        self.inv_cfg = dict(imsize=self.inv_size, pose_mode=self.pose_mode,
                            depth=cfg.get("inv_depth", 6))
        self.network_names = ["generator", "discriminator", "inv_net"]
        self.n_train_images = cfg.get("n_train_images", 1)
        self.n_val_images = cfg.get("n_val_images", 1)
        self.noise_end_it = cfg.get("noise_end_it", 5000)

    # -- state machine contract ----------------------------------------------
    def set_info_from_datasets(self, datasets):
        self.ray_sampler.set_start_intrinsics(np.asarray(datasets[0].intrinsics))
        self.n_train_images = len(datasets[0])
        self.n_val_images = len(datasets[1]) if len(datasets) > 1 else 1

    def setup_optimize_sequences(self, state):
        if state not in SEQUENCES:
            raise AssertionError("model state error")
        return list(SEQUENCES[state])

    def optseq2netnames(self, optseq):
        return list(NETNAMES[optseq])

    def _noise_std(self, it: torch.Tensor) -> torch.Tensor:
        return torch.clamp(1.0 - it / self.noise_end_it, min=0.0)

    # -- framework contract ----------------------------------------------------
    def init(self, seed: int, batch):
        """Seeded weights with flax's initialisers (draws from a CPU
        ``torch.Generator``) and the initial model state, on the framework's
        device.  Returns (net, model_state)."""
        gen = torch.Generator().manual_seed(int(seed))
        disc = Discriminator(**self.disc_cfg)
        inv = InversionNet(**self.inv_cfg)
        net = GanNerfNet(GNeRFRender(**self.generator_cfg), disc, inv,
                         PoseParameters(self.n_train_images, self.pose_mode),
                         PoseParameters(self.n_val_images, self.pose_mode))
        init_flax_defaults(net, gen)
        inv.init_tokens(gen)
        model_state = {"disc_stats": _to(disc.init_stats(gen), self.device),
                       "it": torch.zeros((), dtype=torch.int32, device=self.device)}
        return net.to(self.device), model_state

    def draws(self, rng: Optional[torch.Generator], opt_seq: str, batch_size: int,
              device=None) -> dict:
        """Every random tensor ``opt_seq`` reads for a batch of
        ``batch_size``, from ``rng`` (on ``device``, the framework's by
        default): ``patch`` (the flex sampler's), ``poses`` (the ray
        sampler's), ``render`` (``render_draws``), ``disc`` (one entry
        per discriminator call)."""
        dev = self.device if device is None else device
        B, P, inv = batch_size, self.patch_size, self.inv_size
        S, K = self.generator_cfg["n_samples"], self.generator_cfg["n_importance"]
        policy = self.disc_cfg["policy"]
        out = {}
        if opt_seq in ("generator_trainstep", "discriminator_trainstep"):
            out["patch"] = self.dynamic_patch_sampler.draws(rng, B, dev)
            out["poses"] = self.ray_sampler.pose_draws(rng, B, dev)
            out["render"] = render_draws(rng, B * P * P, S, K, dev)
            n_disc = 1 if opt_seq == "generator_trainstep" else 2
            out["disc"] = [disc_draws(rng, (B, P, P, 3), policy, dev) for _ in range(n_disc)]
        elif opt_seq == "inversion_net_trainstep":
            out["poses"] = self.ray_sampler.pose_draws(rng, B, dev)
            out["render"] = render_draws(rng, B * inv * inv, S, K, dev)
        elif opt_seq in ("training_refine_step", "val_refine_step"):
            out["patch"] = self.dynamic_patch_sampler.draws(rng, B, dev)
            out["render"] = render_draws(rng, B * P * P, S, K, dev)
        elif opt_seq not in NETNAMES:
            raise ValueError(f"unknown opt_seq {opt_seq}")
        return out

    def _render_patches(self, net, draws, poses, coords, it):
        n, h, w, _ = coords.shape
        rays = self.ray_sampler.get_rays(coords, poses, self.img_wh).reshape(-1, 8)
        out = net.generator(rays, draws, perturb=1.0, noise_std=self._noise_std(it))
        return out["coarse"]["rgb"].reshape(n, h, w, 3), out["fine"]["rgb"].reshape(n, h, w, 3)

    def _pose_embed_target(self, poses):
        return poses[:, :3, 3] if self.pose_mode == "3d" else pose_to_d9(poses)

    def loss_fn(self, net, model_state, batch, rng: Optional[torch.Generator] = None,
                state: Optional[str] = "A", opt_seq: Optional[str] = None,
                draws: Optional[dict] = None):
        """One optimize sequence's loss.  ``rng`` (a ``torch.Generator`` on
        the framework's device) draws the sequence's random tensors unless
        ``draws`` (``draws``' layout) gives them.  Returns (loss, {"log_vars",
        "model_state"})."""
        opt_seq = opt_seq or "generator_trainstep"
        dev = self.device
        it = model_state["it"]
        imgs = torch.as_tensor(batch["imgs"], dtype=torch.float32).to(dev)
        B = imgs.shape[0]
        new_state = dict(model_state)
        log = {}
        if opt_seq in ("val_pose_regularization", "val_refine_step") and "val_imgs" in batch:
            src = torch.as_tensor(batch["val_imgs"], dtype=torch.float32).to(dev)
        else:
            src = imgs
        if draws is None:
            draws = self.draws(rng, opt_seq, src.shape[0] if "val" in opt_seq else B)
        draws = _to(draws, dev)

        if opt_seq in ("generator_trainstep", "discriminator_trainstep"):
            coords, scales = self.dynamic_patch_sampler(draws["patch"], B, self.patch_size, it)
            poses = self.ray_sampler.random_poses(draws["poses"])
            y = scales.reshape(-1, 1)
            stats = model_state["disc_stats"]
            if opt_seq == "generator_trainstep":
                _, fake = self._render_patches(net, draws["render"], poses, coords, it)
                d_fake, stats = net.discriminator(fake, y, stats, draws["disc"][0])
                loss = F.softplus(-d_fake).mean()
                new_state["it"] = it + 1
                log["g_loss"] = loss
            else:
                with torch.no_grad():
                    _, fake = self._render_patches(net, draws["render"], poses, coords, it)
                real = sample_image_patches(imgs, coords)
                d_real, stats = net.discriminator(real, y, stats, draws["disc"][0])
                d_fake, stats = net.discriminator(fake, y, stats, draws["disc"][1])
                loss = (F.softplus(-d_real) + F.softplus(d_fake)).mean()
                log.update(d_loss=loss, d_real=d_real.mean(), d_fake=d_fake.mean())
            new_state["disc_stats"] = stats

        elif opt_seq == "inversion_net_trainstep":
            coords, _ = self.static_patch_sampler(B, self.inv_size, dev)
            poses = self.ray_sampler.random_poses(draws["poses"])
            with torch.no_grad():
                _, fake = self._render_patches(net, draws["render"], poses, coords, it)
            loss = ((net.inv_net(fake) - self._pose_embed_target(poses)) ** 2).mean()
            log["inv_loss"] = loss

        elif opt_seq in ("training_pose_regularization", "val_pose_regularization"):
            key = "train_poses" if opt_seq.startswith("training") else "val_poses"
            idx = self._indices(batch, key)
            coords, _ = self.static_patch_sampler(src.shape[0], self.inv_size, dev)
            with torch.no_grad():
                pred = net.inv_net(sample_image_patches(src, coords))
            embed = take_rows(getattr(net, key).poses_embed, idx)
            loss = ((embed - pred) ** 2).mean()
            log[f"{key}_reg_loss"] = loss

        elif opt_seq in ("training_refine_step", "val_refine_step"):
            key = "train_poses" if opt_seq.startswith("training") else "val_poses"
            poses = getattr(net, key)(self._indices(batch, key))
            coords, _ = self.dynamic_patch_sampler(draws["patch"], src.shape[0],
                                                   self.patch_size, it)
            real = sample_image_patches(src, coords)
            fake_c, fake_f = self._render_patches(net, draws["render"], poses, coords, it)
            loss = ((fake_f - real) ** 2).mean() + ((fake_c - real) ** 2).mean()
            log[f"{key}_refine_loss"] = loss
        else:
            raise ValueError(f"unknown opt_seq {opt_seq}")
        return loss, {"log_vars": log, "model_state": new_state}

    def _indices(self, batch, key: str) -> torch.Tensor:
        idx = batch["img_idx"] if key == "train_poses" else batch.get("val_idx",
                                                                      batch["img_idx"])
        return torch.as_tensor(np.asarray(idx) if not torch.is_tensor(idx) else idx
                               ).to(self.device)

    @torch.no_grad()
    def forward_test(self, net, model_state, batch):
        """Full views at the learned val poses (``val_idx``, else
        ``img_idx``): ``rgb`` (n, H, W, 3) in [-1, 1] and ``depth`` (n, H, W)
        of the fine pass, rendered ``RENDER_CHUNK`` rays at a time."""
        poses = net.val_poses(self._indices(batch, "val_poses"))
        coords, _ = self.full_img_sampler(poses.shape[0], self.img_wh, self.device)
        rays = self.ray_sampler.get_rays(coords, poses, self.img_wh).reshape(-1, 8)
        rgb, depth = [], []
        for chunk in rays.split(RENDER_CHUNK):
            out = net.generator(chunk, None, perturb=0.0)["fine"]
            rgb.append(out["rgb"])
            depth.append(out["depth"])
        W, H = self.img_wh
        return {"rgb": torch.cat(rgb).reshape(-1, H, W, 3),
                "depth": torch.cat(depth).reshape(-1, H, W)}, model_state
