"""imgs2mesh: multi-view 3DMM face fitting (port of
``deep3dmap_tpu/models/frameworks/imgs2mesh.py``).

Each view goes through ``Shape3dmmEncoder``; ``param2points_bfm`` turns its
coefficients into BFM vertices (clipped to +-125,000, the BFM's micrometre
scale).  A state without ``unsup`` (``"sup"``) takes the ground-truth point,
pose and landmark losses, and with ``use_sampling`` the texture loss through
the UV sampler; a state with ``unsup`` takes the cross-view point, scale
and (with sampling) texture consistency losses.  ``StateMachineRunner``
sets ``state`` through ``on_state_switch``; ``loss_fn`` takes it as an
argument too.  Registered as ``Imgs2Mesh`` and ``imgs2mesh``.

The V views run through the encoder as one batch of B * V images.  JAX
calls it once per view; GroupNorm normalises each image alone, so the
numbers are the same (``tests/test_torch_imgs2mesh.py``) and the card
launches a third of the kernels at V = 3.

On a mesh (``set_mesh``) the batch splits over the ``data`` axis by sample,
each sample's V views on one rank (the consistency terms compare the views
of a sample), and every mean is the global batch's
(``parallel/collectives.py::global_mean``).

Reference quirk kept: with ``use_sampling`` the ``sup`` state reads
``batch["uvtex"]``, which ``MultiPIEFaceTupleDataset`` does not give, so
``configs/pt3d_demos/imgs2face_multipie.py`` as published raises
``KeyError: 'uvtex'`` at its first step, in JAX as here.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ...core.all3dmm.bfm_tools import load_bfm_mat, make_synthetic_bfm, param2points_bfm
from ...core.all3dtrans.rotations import euler_angles_to_matrix
from ...core.renderer.uv_sampler import (precompute_uv_rasterization, sample_uv_texture,
                                         vertex_visibility)
from ...parallel.collectives import global_mean
from ...utils.device import DeviceLike, resolve_device
from ...utils.from_flax import load_flax_params
from ..backbones.shape_encoder import Shape3dmmEncoder
from ..builder import RECONSTRUCTORS
from ..losses.basic import l1_loss
from .base import BaseFramework

PTS_CLIP = 125000.0
ANGLE_CLIP = 3.1415


@RECONSTRUCTORS.register_module(name=["Imgs2Mesh", "imgs2mesh"])
class Imgs2Mesh(BaseFramework):
    """``device``: where the network, the BFM and the UV tables live (CUDA
    unless ``"cpu"`` is asked for).  ``bfm`` in the config is a
    ``BFMModel``; without it and without the ``.mat`` paths the synthetic
    BFM of ``n_verts`` vertices."""

    is_multi_opt_iters = False

    def __init__(self, model_cfgs: dict, train_cfg=None, test_cfg=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        cfg = dict(model_cfgs)
        self.tuplesize = cfg.get("tuplesize", 3)
        self.image_size = cfg.get("image_size", 256)
        self.texture_size = cfg.get("texture_size", 64)
        self.use_sampling = cfg.get("use_sampling", False)
        self.state = "sup"

        if cfg.get("shape_param_path"):
            bfm = load_bfm_mat(cfg["shape_param_path"], cfg["exp_param_path"],
                               cfg["other_param_path"])
        else:
            bfm = cfg.get("bfm") or make_synthetic_bfm(n_verts=cfg.get("n_verts", 512))
        self.bfm = bfm.to(self.device)

        self.lookview = torch.tensor([0.0, 0.0, 1.0], device=self.device)
        if self.use_sampling:
            uvs = cfg.get("template_uvs")
            if uvs is None:
                uvs = np.random.RandomState(7).rand(self.bfm.n_verts, 2)
            self.template_uvs = np.asarray(uvs, np.float32)
            normals = cfg.get("template_normals")
            if normals is None:
                mu = bfm.mu_shape.cpu().numpy().reshape(-1, 3)
                normals = mu / (np.linalg.norm(mu, axis=1, keepdims=True) + 1e-9)
            normals = np.asarray(normals)
            if np.mean(normals[:, 2]) < 0:
                normals = -normals
            self.template_normals = torch.from_numpy(
                np.asarray(normals, np.float32)).to(self.device)
            self.rast = precompute_uv_rasterization(
                self.template_uvs, bfm.triangles.cpu().numpy(), self.texture_size,
                device=self.device)
        self.net = Shape3dmmEncoder(n_param=self.bfm.n_shape + self.bfm.n_exp)
        self.loss_group = None

    def set_mesh(self, mesh) -> bool:
        """The losses' means go over the mesh's ``data`` axis."""
        self.loss_group = mesh.group("data")
        return False

    def on_state_switch(self, state: str):
        self.state = state

    def _t(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=torch.float32, device=self.device)

    # -- forward -------------------------------------------------------------
    def _forward(self, net, imgs):
        """imgs (B, V, H, W, 3) -> per-view points (B, N, 3) and poses (B, 7)."""
        B, V = imgs.shape[:2]
        preds = net(imgs.reshape(B * V, *imgs.shape[2:]))
        pts, pose = param2points_bfm(self.bfm, preds)
        pts = torch.clamp(pts, -PTS_CLIP, PTS_CLIP).reshape(B, V, *pts.shape[1:])
        pose = pose.reshape(B, V, -1)
        return [pts[:, k] for k in range(V)], [pose[:, k] for k in range(V)]

    def _project(self, pts, s, R, T):
        """(s * R @ pts^T + T * image_size)^T."""
        proj = s[:, None, None] * torch.einsum("bij,bnj->bni", R, pts)
        return proj + T[:, None, :] * self.image_size

    def _uv_sample(self, imgs_k, pts, pose):
        s = pose[:, 0]
        angles = torch.clamp(pose[:, 1:4], -ANGLE_CLIP, ANGLE_CLIP)
        R = euler_angles_to_matrix(angles, "XYZ")
        fp = self._project(pts, s, R, pose[:, 4:7])[..., :2] / self.image_size
        fp = torch.stack([fp[..., 0], 1.0 - fp[..., 1]], dim=-1)
        vis = vertex_visibility(self.template_normals, angles, self.lookview)
        return sample_uv_texture(self.rast, imgs_k, fp, vis)

    # -- losses (JAX :108-163) -------------------------------------------------
    def _losses(self, net, batch, state):
        imgs = self._t(batch["imgs"])
        outpts, outpose = self._forward(net, imgs)
        g = self.loss_group
        V = len(outpts)
        losses = {}

        if "sup" in state and "unsup" not in state:
            gtaux = self._t(batch["gtaux"])    # (B, V, 152)
            gtobj = self._t(batch["gtobj"])    # (B, N, 3)
            losses["ptsloss"] = sum(1e-4 * l1_loss(outpts[k], gtobj, group=g)
                                    for k in range(V))
            poseloss, lm68loss = 0.0, 0.0
            kp = self.bfm.keypoints
            for k in range(V):
                s, T = outpose[k][:, 0], outpose[k][:, 4:7]
                reflm68 = gtaux[:, k, :136].reshape(-1, 68, 2)
                refs = gtaux[:, k, 136]
                refT = gtaux[:, k, 146:149]
                refAngle = gtaux[:, k, 149:152]
                poseloss = poseloss + (20.0 * l1_loss(s, refs, group=g)
                                       + l1_loss(outpose[k][:, 1:4], refAngle, group=g)
                                       + l1_loss(T[:, :2], refT[:, :2], group=g))
                angles = torch.clamp(outpose[k][:, 1:4], -ANGLE_CLIP, ANGLE_CLIP)
                R = euler_angles_to_matrix(angles, "XYZ")
                lm68 = self._project(outpts[k], s, R, T)[:, kp, :2]
                lm68loss = lm68loss + 0.02 * l1_loss(lm68, reflm68, group=g)
            losses["poseloss"] = poseloss
            losses["lm68loss"] = lm68loss

            if self.use_sampling:
                uvtex = self._t(batch["uvtex"])    # (B, S, S, 3)
                texloss = 0.0
                for k in range(V):
                    uvimg, uvmask = self._uv_sample(imgs[:, k], outpts[k], outpose[k])
                    texloss = texloss + 2.0 * global_mean(torch.abs(uvimg - uvtex) * uvmask, g)
                losses["texloss"] = texloss

        if "unsup" in state:
            losses["pts_consistent_loss"] = sum(
                0.01 * l1_loss(outpts[k], outpts[k + 1], group=g) for k in range(V - 1))
            losses["scale_consistent_loss"] = sum(
                2000.0 * l1_loss(outpose[k][:, 0], outpose[k + 1][:, 0], group=g)
                for k in range(V - 1))
            if self.use_sampling:
                uvs = [self._uv_sample(imgs[:, k], outpts[k], outpose[k]) for k in range(V)]
                tex_c = 0.0
                for k in range(V - 1):
                    m = uvs[k][1] * uvs[k + 1][1]
                    tex_c = tex_c + 200.0 * global_mean(
                        torch.abs(uvs[k][0] - uvs[k + 1][0]) * m, g)
                losses["tex_consistent_loss"] = tex_c
        return losses, (outpts, outpose)

    # -- framework contract ------------------------------------------------------
    def init(self, seed: int, batch):
        """Seeded weights (JAX's init rule, ``Shape3dmmEncoder.init_weights``)
        from a CPU ``torch.Generator``, on the framework's device.  Returns
        (net, model_state {})."""
        self.net.cpu().init_weights(torch.Generator().manual_seed(int(seed)))
        self.net.to(self.device)
        return self.net, {}

    def load_flax(self, params: Mapping):
        """Load a JAX ``Imgs2Mesh.init`` params tree; returns the net."""
        load_flax_params(self.net.cpu(), params)
        return self.net.to(self.device)

    def loss_fn(self, params, model_state, batch, rng=None, state: Optional[str] = None,
                opt_seq: Optional[str] = None):
        losses, _ = self._losses(params, batch, state if state is not None else self.state)
        return sum(losses.values()), {"log_vars": losses, "model_state": model_state}

    @torch.no_grad()
    def val_fn(self, params, model_state, batch):
        return {"log_vars": self._losses(params, batch, self.state)[0]}

    @torch.no_grad()
    def forward_test(self, params, model_state, batch):
        outpts, outpose = self._forward(params, self._t(batch["imgs"]))
        return {"outpts_list": outpts, "outpose_list": outpose}, model_state
