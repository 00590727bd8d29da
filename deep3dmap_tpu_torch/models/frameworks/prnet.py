"""PRNet: one face image -> its UV position map (port of
``deep3dmap_tpu/models/frameworks/prnet.py``).

``ResFCN256`` regresses an (R, R, 3) position map; the loss is the weight
mask's L1 over the map plus the L1 of the 68 landmark texels; NME is
evaluated by the datasets (``core/evaluation/face_eval.py``).  The landmark
texel indices come, in JAX's order, from ``uv_kpt_ind`` (an array), then
``uv_kpt_ind_file``, then a BFM's ``.mat`` files (``bfm``), then the
synthetic BFM.  Registered as ``FaceImg2UV`` and ``faceimg2uv``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ...core.all3dmm.bfm_tools import load_bfm_mat, make_synthetic_bfm
from ...utils.device import DeviceLike, resolve_device
from ...utils.from_flax import load_flax_params
from ..backbones.resfcn256 import ResFCN256
from ..builder import RECONSTRUCTORS
from ..layers import init_flax_defaults
from ..losses.basic import l1_loss, mask_l1_loss
from .base import BaseFramework


def bfm_uv_coords(model, resolution: int) -> np.ndarray:
    """Per-vertex texel coordinates (N, 2) int32 from a cylindrical unwrap
    of the BFM's mean shape (JAX :23-37)."""
    mu = np.asarray(model.mu_shape, np.float64).reshape(-1, 3)
    p = mu - mu.mean(0)
    az = np.arctan2(p[:, 0], p[:, 2])
    u = (az - az.min()) / max(az.max() - az.min(), 1e-9)
    v = (p[:, 1] - p[:, 1].min()) / max(p[:, 1].max() - p[:, 1].min(), 1e-9)
    xs = np.clip(np.round(u * (resolution - 1)), 0, resolution - 1)
    ys = np.clip(np.round((1.0 - v) * (resolution - 1)), 0, resolution - 1)
    return np.stack([xs, ys], -1).astype(np.int32)


def uv_kpt_ind_from_bfm(model=None, resolution: int = 256) -> np.ndarray:
    """(2, 68) landmark texel indices [x_ind, y_ind]: where each of the
    BFM's 68 keypoint vertices lies in ``bfm_uv_coords``' atlas; the
    synthetic BFM (seed 0) when ``model`` is None."""
    if model is None:
        model = make_synthetic_bfm()
    uv = bfm_uv_coords(model, resolution)
    return uv[np.asarray(model.keypoints)].T.copy()


def _read_mask(path: str) -> np.ndarray:
    """``cv2.imread(path)``'s array, as float64: 3-channel BGR."""
    from ...utils.image_io import imread

    m = imread(path)
    if m.ndim == 2:
        m = m[..., None].repeat(3, axis=-1)
    return m[..., :3].astype(np.float64)


@RECONSTRUCTORS.register_module(name=["FaceImg2UV", "faceimg2uv"])
class FaceImg2UV(BaseFramework):
    """``device``: where the network and the steps run (CUDA unless
    ``"cpu"`` is asked for)."""

    def __init__(self, model_cfgs: dict, train_cfg=None, test_cfg=None, pretrained=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        cfg = dict(model_cfgs)
        self.resolution = cfg.get("resolution", 256)
        self.kpt_weight = cfg.get("kpt_weight", 1.0)
        self.base_channels = int(cfg.get("base_channels", 16))

        if cfg.get("uv_kpt_ind") is not None:
            uv_kpt_ind = np.asarray(cfg["uv_kpt_ind"], np.int32)
        elif cfg.get("uv_kpt_ind_file"):
            uv_kpt_ind = np.loadtxt(cfg["uv_kpt_ind_file"]).astype(np.int32)
        elif cfg.get("bfm"):
            uv_kpt_ind = uv_kpt_ind_from_bfm(load_bfm_mat(**cfg["bfm"]), self.resolution)
        else:
            uv_kpt_ind = uv_kpt_ind_from_bfm(None, self.resolution)
        self.uv_kpt_ind = uv_kpt_ind
        self._kpt_idx = torch.from_numpy(uv_kpt_ind.astype(np.int64)).to(self.device)

        # the weight mask (R, R, 1): an array, image files read as cv2 reads
        # them, or uniform
        mask = cfg.get("weight_mask")
        if mask is None and cfg.get("weightmaskfile"):
            m = _read_mask(cfg["weightmaskfile"])
            if cfg.get("facemaskfile"):
                m = m * _read_mask(cfg["facemaskfile"])
            mask = (m / max(m.max(), 1e-12))[..., :1]
        if mask is None:
            mask = np.ones((self.resolution, self.resolution, 1), np.float32)
        self.weight_mask = torch.from_numpy(np.asarray(mask, np.float32).reshape(
            self.resolution, self.resolution, -1)[..., :1].copy()).to(self.device)
        self.net = ResFCN256(out_ch=3, base=self.base_channels)

    def _t(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=torch.float32, device=self.device)

    def _kpts(self, uvpos: torch.Tensor) -> torch.Tensor:
        """uvpos (B, R, R, 3) -> (B, 3, 68) at the landmark texels."""
        return uvpos[:, self._kpt_idx[1], self._kpt_idx[0], :].transpose(1, 2)

    def init(self, seed: int, batch):
        """Seeded flax-default weights from a CPU ``torch.Generator``, on the
        framework's device.  Returns (net, model_state {})."""
        init_flax_defaults(self.net.cpu(), torch.Generator().manual_seed(int(seed)))
        self.net.to(self.device)
        return self.net, {}

    def load_flax(self, params: Mapping):
        """Load a JAX ``FaceImg2UV.init`` params tree (nested numpy arrays);
        returns the net."""
        load_flax_params(self.net.cpu(), params)
        return self.net.to(self.device)

    def _loss_uv(self, uvpos, batch):
        return mask_l1_loss(uvpos, self._t(batch["gt_uvimg"]), self.weight_mask[None])

    def loss_fn(self, params, model_state, batch, rng=None):
        uvpos = params(self._t(batch["faceimg"]))
        loss_uv = self._loss_uv(uvpos, batch)
        loss_kpt = l1_loss(self._kpts(uvpos), self._kpts(self._t(batch["gt_uvimg"]))) \
            * self.kpt_weight
        return loss_uv + loss_kpt, {"log_vars": {"loss_uv": loss_uv, "loss_kpt": loss_kpt},
                                    "model_state": model_state}

    @torch.no_grad()
    def val_fn(self, params, model_state, batch):
        uvpos = params(self._t(batch["faceimg"]))
        return {"log_vars": {"loss_uv": self._loss_uv(uvpos, batch)}}

    @torch.no_grad()
    def forward_test(self, params, model_state, batch):
        uvpos = params(self._t(batch["faceimg"]))
        return {"uvpos": uvpos, "kpt": self._kpts(uvpos)}, model_state
