"""NeuralRecon: real-time monocular-video TSDF reconstruction.

Port of ``deep3dmap_tpu/models/frameworks/neuralrecon.py``: MnasFPN features
-> coarse-to-fine voxel pyramid (24³ -> 48³ -> 96³ at N_VOX=96) with
multi-view back-projection -> 3D UNet -> ConvGRU fusion into recurrent global
volumes -> tsdf/occupancy heads and per-level losses.  Two pyramid modes:
"dense" (every voxel convolved, occupancy-masked) and "block" (levels >= 1
compute only on a fixed-capacity set of active 8³ blocks,
``ops/block_sparse.py``).

Ported: streaming inference (``forward_test``), validation (``val_fn``)
and the training loss (``loss_fn``, differentiable by autograd; its
per-level loss runs the fused-loss kernels, forward and backward, on CUDA).
Not ported yet: ``set_mesh``/spatial GRU sharding, ``_graft_backbone``
(BACKBONE2D.CKPT), ``BP_GRAD_FRAC`` (a backward-only option) and the scanned
and rematerialised trunk (the batched-views trunk gives the same numbers).

Batch layout as in the JAX package: imgs (B, V, H, W, 3) NHWC, volumes
NDHWC, dict keys unchanged.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ...datasets.builder import upload_batch
from ...ops.back_project import (_voxel_world_from_flat, back_project_batch,
                                 back_project_masked_batch,
                                 back_project_sparse_batch)
from ...ops.block_sparse import (block_mask_from_voxels, block_voxel_indices,
                                 blocks_to_dense, blocks_to_dense_over,
                                 child_block_mask, dense_to_blocks,
                                 gather_parent_octants, select_blocks)
from ...ops.fused_loss import fused_tsdf_occ_loss, fused_tsdf_occ_loss_levels
from ...utils.device import resolve_device
from ...utils.from_flax import load_flax_params
from ..backbones.fpn2d import MnasFPN
from ..builder import RECONSTRUCTORS
from ..layers import Dense, init_flax_defaults
from ..modulars.block_dense3d import BlockConvGRU3D, BlockUNet3D, _up2_block
from ..modulars.conv_gru3d import ConvGRU3D
from ..modulars.dense3d import UNet3D, _up2
from ..modulars.global_volume import (GlobalVolumeState, init_global_volumes,
                                      read_windows_batch, reset_volumes,
                                      write_windows_batch)
from .base import BaseFramework

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def _dtype(name: Optional[str]) -> Optional[torch.dtype]:
    return None if name is None else _DTYPES[str(name)]


def apply_log_transform(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * log(1 + |x|) (parity: neucon_utils.apply_log_transform)."""
    return torch.sign(x) * torch.log(torch.abs(x) + 1.0)


class _FPNBatch(nn.Module):
    """All views through the FPN as one conv batch (flax scope
    ``backbone2d/fpn``)."""

    def __init__(self, **kw):
        super().__init__()
        self.fpn = MnasFPN(**kw)


class NeuralReconNet(nn.Module):
    """Features -> coarse-to-fine pyramid; submodules carry flax's names."""

    def __init__(self, n_vox: int = 96, n_layers: int = 3,
                 voxel_size: float = 0.04, alpha: float = 1.0,
                 backbone_norm: str = "gn", backbone_torch_pad: bool = False,
                 backbone_freeze: bool = False,
                 backbone_dtype: Optional[str] = None, fusion_on: bool = True,
                 out_channels: Sequence[int] = (96, 48, 24),
                 thresholds: Sequence[float] = (0.0, 0.0, 0.0),
                 num_sample: Sequence = (None, None, None),
                 bp_gather_dtype: Optional[str] = "bfloat16",
                 sparse_mode: str = "dense", block_size: int = 8,
                 max_blocks: Sequence = (None, 64, 256),
                 block_dtype: Optional[str] = None):
        super().__init__()
        self.n_vox, self.n_layers, self.voxel_size = n_vox, n_layers, voxel_size
        self.backbone_freeze = backbone_freeze
        self.fusion_on = fusion_on
        self.add_coord_feats = True
        self.out_channels = tuple(out_channels)
        self.thresholds = tuple(thresholds)
        self.num_sample = tuple(num_sample)
        # TRAP: the gather table is bf16 by default on every path (the JAX
        # NeuralRecon never overrides NeuralReconNet.bp_gather_dtype)
        self.bp_gather_dtype = _dtype(bp_gather_dtype)
        self.sparse_mode = sparse_mode
        self.block_size = block_size
        self.max_blocks = tuple(max_blocks)
        bdt = _dtype(block_dtype)

        self.backbone2d = _FPNBatch(alpha=alpha, norm=backbone_norm,
                                    torch_pad=backbone_torch_pad,
                                    dtype=_dtype(backbone_dtype))
        feat_ch = self.backbone2d.fpn.channels        # (fine, mid, coarse)
        for i in range(n_layers):
            c_in = feat_ch[n_layers - 1 - i] + 1       # + normalised depth
            if i > 0:
                c_in += self.out_channels[i - 1] + 2   # up feat, tsdf, occ
            c_in += 3 if self.add_coord_feats else 0
            c = self.out_channels[i]
            block = i > 0 and sparse_mode == "block"
            if block:
                setattr(self, f"unet{i}", BlockUNet3D(c_in, c, cr=1.0 / 2 ** i,
                                                      dtype=bdt))
            else:
                setattr(self, f"unet{i}", UNet3D(c_in, c, cr=1.0 / 2 ** i))
            if fusion_on:
                gru = BlockConvGRU3D(c, c, dtype=bdt) if block else ConvGRU3D(c, c)
                setattr(self, f"gru{i}", gru)
            setattr(self, f"tsdf_pred{i}", Dense(c, 1))
            setattr(self, f"occ_pred{i}", Dense(c, 1))

    def _aligned_coords(self, world, w2ac):
        """World points (B, ..., 3) -> normalised aligned-camera coordinates
        (the dense analogue of SPVCNN's point-coordinate branch)."""
        R = w2ac[:, :3, :3]
        t = w2ac[:, :3, 3]
        shape = world.shape
        flat = world.reshape(shape[0], -1, 3)
        ali = torch.einsum("bkj,bij->bki", flat, R) + t[:, None, :]
        return (ali / (self.n_vox * self.voxel_size)).reshape(shape)

    def forward(self, imgs, proj_matrices, vol_origin_partial,
                world_to_aligned_camera, hidden_windows: Optional[List] = None):
        """Returns per-level lists 'tsdf' (B,d,d,d,1), 'occ' (logits),
        'count_mask', 'sparse_mask' and the 'new_hidden' windows."""
        B, V = imgs.shape[0], imgs.shape[1]
        n_scales = self.n_layers - 1
        pyramid = self.backbone2d.fpn(imgs.reshape((B * V,) + imgs.shape[2:]))
        # pyramid[s]: (B, V, H/4/2^s, W/4/2^s, C_s)
        pyramid = [f.reshape((B, V) + f.shape[1:]) for f in pyramid]
        if self.backbone_freeze:
            pyramid = [f.detach() for f in pyramid]
        w2ac = world_to_aligned_camera

        outputs: Dict[str, Any] = {"tsdf": [], "occ": [], "count_mask": [],
                                   "sparse_mask": [], "new_hidden": []}
        prev_feat = prev_tsdf = prev_occ = prev_mask = None
        prev_block = None  # block-domain carry between consecutive block levels
        gdt = self.bp_gather_dtype

        for i in range(self.n_layers):
            scale = n_scales - i
            interval = 2 ** scale
            dim = self.n_vox // interval
            feats = pyramid[scale]
            proj = proj_matrices[:, :, scale]
            cap = self.num_sample[i]
            unet = getattr(self, f"unet{i}")
            gru = getattr(self, f"gru{i}", None)
            tsdf_pred = getattr(self, f"tsdf_pred{i}")
            occ_pred = getattr(self, f"occ_pred{i}")
            if i > 0 and self.sparse_mode == "block":
                # ---- block-sparse level: all compute on active 8³ blocks ----
                bs = self.block_size
                if dim % bs or (dim // 2) % (bs // 2):
                    raise ValueError(
                        f"SPARSE_MODE='block' needs level dims divisible by "
                        f"BLOCK_SIZE={bs}; level {i} is {dim}³")
                nb = dim // bs
                maxb = min(int(self.max_blocks[i] or nb ** 3), nb ** 3)
                # active blocks = blocks holding any occupied parent voxel
                if prev_block is None:
                    bmask = block_mask_from_voxels(prev_mask, bs // 2)
                else:
                    bmask = child_block_mask(prev_block["occm"],
                                             prev_block["bset"])
                bset = select_blocks(bmask, maxb, bs)
                vidx = block_voxel_indices(bset)                 # (B, MAXB*bs³)
                slot_valid = bset.valid.repeat_interleave(bs ** 3, dim=1)

                f, cnt = back_project_sparse_batch(
                    feats, proj, vol_origin_partial, vidx, slot_valid,
                    dim=dim, voxel_size=self.voxel_size, interval=interval,
                    gather_dtype=gdt)
                volume_b = f.reshape(B, maxb, bs, bs, bs, f.shape[-1])
                cnt_b = cnt.reshape(B, maxb, bs, bs, bs)
                count_mask = blocks_to_dense(cnt_b[..., None], bset)[..., 0] > 1

                # parent-level context, gathered block-wise and upsampled 2x
                if prev_block is None:
                    pset = bset._replace(bs=bs // 2)

                    def gather_up(v):
                        return _up2_block(dense_to_blocks(v, pset))
                    up_feat = gather_up(prev_feat)
                    up_tsdf = gather_up(prev_tsdf)
                    up_occ = gather_up(prev_occ)
                    vox_mask_b = gather_up(prev_mask[..., None].float())[..., 0]
                else:
                    # one octant gather for the context stack (feat | tsdf |
                    # occ | mask); fill = empty space (tsdf=1) where the
                    # parent block is inactive
                    pb = prev_block
                    Cp = pb["feat"].shape[-1]
                    ctx = torch.cat([pb["feat"], pb["tsdf"], pb["occ"],
                                     pb["occm"][..., None].to(pb["feat"].dtype)],
                                    dim=-1)
                    # built on the device: writing a host scalar into a
                    # CUDA tensor would wait for the device
                    fill = (torch.arange(Cp + 3, device=ctx.device)
                            == Cp).to(ctx.dtype)
                    g = _up2_block(gather_parent_octants(ctx, pb["bset"], bset,
                                                         fill=fill))
                    up_feat = g[..., :Cp]
                    up_tsdf = g[..., Cp:Cp + 1]
                    up_occ = g[..., Cp + 1:Cp + 2]
                    vox_mask_b = g[..., Cp + 2]
                parts = [volume_b, up_feat, up_tsdf, up_occ]
                if self.add_coord_feats:
                    world = _voxel_world_from_flat(
                        vidx, dim, self.voxel_size,
                        vol_origin_partial[:, None, :], interval)  # (B, K, 3)
                    parts.append(self._aligned_coords(world, w2ac).reshape(
                        B, maxb, bs, bs, bs, 3))
                feat_in = torch.cat(parts, dim=-1)
                feat_in = feat_in * vox_mask_b[..., None].to(feat_in.dtype)

                feat_b = unet(feat_in, bset)
                if self.fusion_on:
                    h_b = dense_to_blocks(hidden_windows[i], bset)
                    feat_b = gru(h_b, feat_b, bset)
                    # inactive blocks keep their old hidden state
                    outputs["new_hidden"].append(blocks_to_dense_over(
                        feat_b, bset, hidden_windows[i]))

                tsdf_b = tsdf_pred(feat_b)
                occ_b = occ_pred(feat_b)
                outputs["tsdf"].append(blocks_to_dense(tsdf_b, bset, fill=1.0))
                outputs["occ"].append(blocks_to_dense(occ_b, bset))
                outputs["count_mask"].append(count_mask)
                outputs["sparse_mask"].append(
                    blocks_to_dense(vox_mask_b[..., None], bset)[..., 0] > 0.5)

                # block-domain occupancy carries to the next level without
                # touching the dense volume
                occupancy_b = (occ_b[..., 0] > self.thresholds[i]) & (vox_mask_b > 0.5)
                if not self.fusion_on:
                    occupancy_b = occupancy_b & (cnt_b > 1)
                prev_block = dict(bset=bset, feat=feat_b, tsdf=tsdf_b,
                                  occ=occ_b, occm=occupancy_b)
                continue

            if i > 0 and cap is not None and cap < dim ** 3:
                up_mask = _up2(prev_mask[..., None])[..., 0]
                volume, count = back_project_masked_batch(
                    feats, proj, vol_origin_partial, up_mask, cap, dim,
                    self.voxel_size, interval, gather_dtype=gdt)
            else:
                volume, count = back_project_batch(
                    feats, proj, vol_origin_partial, dim, self.voxel_size,
                    interval, gather_dtype=gdt)
            count_mask = count > 1  # seen by >1 view (neucon_network.py:132)

            parts = [volume]
            if i > 0:
                parts.extend([_up2(prev_feat), _up2(prev_tsdf), _up2(prev_occ)])
                sparse_mask = _up2(prev_mask[..., None])[..., 0]
            else:
                sparse_mask = torch.ones_like(count_mask)
            if self.add_coord_feats:
                r = torch.arange(dim, dtype=torch.float32,
                                 device=imgs.device) * interval
                gx, gy, gz = torch.meshgrid(r, r, r, indexing="ij")
                grid = torch.stack([gx, gy, gz], dim=-1) * self.voxel_size
                world = grid[None] + vol_origin_partial[:, None, None, None, :]
                parts.append(self._aligned_coords(world, w2ac))
            feat_in = torch.cat(parts, dim=-1)
            # gate by the sparse set (where the reference's sparse conv runs)
            feat_in = feat_in * sparse_mask[..., None].to(feat_in.dtype)

            feat = unet(feat_in)
            if self.fusion_on:
                feat = gru(hidden_windows[i], feat)
                outputs["new_hidden"].append(feat)

            tsdf = tsdf_pred(feat)
            occ = occ_pred(feat)
            outputs["tsdf"].append(tsdf)
            outputs["occ"].append(occ)
            outputs["count_mask"].append(count_mask)
            outputs["sparse_mask"].append(sparse_mask)

            occupancy = (occ[..., 0] > self.thresholds[i]) & sparse_mask.bool()
            if not self.fusion_on:
                occupancy = occupancy & count_mask
            prev_feat, prev_tsdf, prev_occ, prev_mask = feat, tsdf, occ, occupancy
        return outputs


@RECONSTRUCTORS.register_module()
class NeuralRecon(BaseFramework):
    """Framework wrapper: global-volume state handling + losses.

    ``model_cfgs`` keys as in the JAX package (N_LAYER, N_VOX, VOXEL_SIZE,
    FUSION, LW, THRESHOLDS, POS_WEIGHT, BACKBONE2D, TRAIN_NUM_SAMPLE,
    SPARSE_MODE, BLOCK_SIZE, MAX_BLOCKS, BLOCK_DTYPE, GLOBAL_DIMS,
    GLOBAL_DTYPE, IMG_NORM).  ``device`` defaults to CUDA and raises without
    a GPU unless ``"cpu"`` is asked for.
    """

    def __init__(self, model_cfgs: dict, train_cfg=None, test_cfg=None,
                 pretrained=None, device=None):
        cfg = dict(model_cfgs)
        self.n_layers = cfg.get("N_LAYER", 3)
        self.n_vox = cfg.get("N_VOX", [96, 96, 96])[0]
        self.voxel_size = cfg.get("VOXEL_SIZE", 0.04)
        fusion = dict(cfg.get("FUSION", {}))
        self.fusion_on = fusion.get("FUSION_ON", True)
        self.fusion_full = fusion.get("FULL", True)
        self.lw = cfg.get("LW", [1.0, 0.8, 0.64])
        self.thresholds = tuple(cfg.get("THRESHOLDS", [0, 0, 0]))
        self.pos_weight = cfg.get("POS_WEIGHT", 1.0)
        bb2d = dict(cfg.get("BACKBONE2D", {}))
        alpha = float(str(bb2d.get("ARC", "fpn-mnas-1")).split("-")[-1])
        if bb2d.get("CKPT", pretrained):
            raise NotImplementedError(
                "BACKBONE2D.CKPT / pretrained backbone grafting is not ported "
                "yet; load the weights with NeuralRecon.load_flax instead")
        self.out_channels = tuple(cfg.get("CHANNELS", (96, 48, 24)))
        # per-level active-voxel capacity: a TRAIN_NUM_SAMPLE list of
        # n_layers entries is a per-level budget (neucon_network.py:190-194);
        # n_layers-1 entries keep the legacy parent-cap x8 mapping
        train_ns = cfg.get("TRAIN_NUM_SAMPLE")
        num_sample = [None] * self.n_layers
        if train_ns is not None:
            for i in range(1, self.n_layers):
                dim_i = self.n_vox // 2 ** (self.n_layers - 1 - i)
                if len(train_ns) >= self.n_layers:
                    num_sample[i] = min(int(train_ns[i]), dim_i ** 3)
                else:
                    num_sample[i] = min(int(train_ns[i - 1]) * 8, dim_i ** 3)
        self.num_sample = tuple(cfg.get("NUM_SAMPLE", num_sample))
        self.sparse_mode = cfg.get("SPARSE_MODE", "dense")
        self.block_size = int(cfg.get("BLOCK_SIZE", 8))
        max_blocks = [None] * self.n_layers
        for i in range(1, self.n_layers):
            if self.num_sample[i] is not None:
                max_blocks[i] = -(-int(self.num_sample[i]) // self.block_size ** 3)
        self.max_blocks = tuple(cfg.get("MAX_BLOCKS", max_blocks))
        self.global_dims = tuple(cfg.get("GLOBAL_DIMS", self._window_dims()))
        self.global_dtype = _dtype(cfg.get("GLOBAL_DTYPE")) or torch.float32
        self.img_norm = tuple(cfg.get("IMG_NORM", (0.0, 1.0)))
        self.test_cfg = test_cfg
        self.device = resolve_device(device)

        self.net = NeuralReconNet(
            n_vox=self.n_vox, n_layers=self.n_layers, voxel_size=self.voxel_size,
            alpha=alpha, backbone_norm=bb2d.get("NORM", "gn"),
            backbone_torch_pad=bool(bb2d.get("TORCH_PAD", False)),
            backbone_freeze=bool(bb2d.get("FREEZE", False)),
            backbone_dtype=bb2d.get("DTYPE"), fusion_on=self.fusion_on,
            out_channels=self.out_channels, thresholds=self.thresholds,
            num_sample=self.num_sample, sparse_mode=self.sparse_mode,
            block_size=self.block_size, max_blocks=self.max_blocks,
            block_dtype=cfg.get("BLOCK_DTYPE")).eval()

    # -- weights and state -------------------------------------------------
    def init(self, seed: int, batch):
        """Seeded init mirroring flax's defaults.  Returns (params,
        model_state) where ``params`` is the network module."""
        init_flax_defaults(self.net, torch.Generator().manual_seed(int(seed)))
        self.net.to(self.device)
        return self.net, self.init_state(np.shape(batch["imgs"])[0])

    def load_flax(self, flax_params):
        """Load a JAX ``NeuralRecon.init`` param tree (nested numpy arrays)."""
        load_flax_params(self.net.cpu(), flax_params)
        self.net.to(self.device)
        return self.net

    def init_state(self, batch_size: int):
        model_state = {}
        if self.fusion_on:
            model_state["global_hidden"] = init_global_volumes(
                batch_size, self.global_dims, self.out_channels,
                dtype=self.global_dtype, device=self.device)
        return model_state

    # -- helpers -----------------------------------------------------------
    def _window_dims(self):
        """Window side length per level i (coarse -> fine)."""
        return [self.n_vox // 2 ** (self.n_layers - 1 - i)
                for i in range(self.n_layers)]

    def batch_to_device(self, batch):
        """Numeric arrays (numpy or torch, and lists of them) -> tensors on
        this framework's device, float64 as float32; strings and other
        metadata pass through."""
        return upload_batch(batch, self.device)

    def _rel_origins(self, batch):
        """Fragment origin per level in that level's voxel units, relative
        to the scene origin (parity: gru_fusion.py:239)."""
        origin = batch["vol_origin_partial"]
        global_origin = batch["vol_origin"]
        return [(origin - global_origin)
                / (self.voxel_size * 2 ** (self.n_layers - 1 - i))
                for i in range(self.n_layers)]

    def host_check_batch(self, batch):
        """Host-side batch check that the runners call before the upload
        (parity: JAX ``neuralrecon.py:605-642``).

        Warns once when a fragment origin would clamp against the global
        hidden extent: with GLOBAL_DIMS smaller than the scene, every
        fragment beyond the extent aliases into the same corner window.  Fix:
        set model_cfgs.GLOBAL_DIMS from the dataset's scene bounds (see
        configs/neural_recon/scannet.py)."""
        if not self.fusion_on or "vol_origin_partial" not in batch:
            return
        if getattr(self, "_warned_clamp", False):
            return
        origin = np.asarray(batch["vol_origin_partial"], np.float32)
        gorigin = np.asarray(batch.get("vol_origin", np.zeros(3)), np.float32)
        dims = self._window_dims()
        for i in range(self.n_layers):
            vs = self.voxel_size * 2 ** (self.n_layers - 1 - i)
            rel = np.round((origin - gorigin) / vs).astype(np.int64)
            hi = self.global_dims[i] - dims[i]
            if (rel < 0).any() or (rel > hi).any():
                logging.getLogger("deep3dmap_tpu_torch").warning(
                    "NeuralRecon: fragment origin %s clamps against the "
                    "global hidden extent at level %d (GLOBAL_DIMS[%d]=%d, "
                    "window=%d, rel voxel origin %s outside [0, %d]). "
                    "Fragments beyond the extent alias into the same corner "
                    "window -- set model_cfgs.GLOBAL_DIMS to cover the scene "
                    "bounds (e.g. ceil(scene_extent_m / voxel_size) at the "
                    "finest scale).",
                    origin.tolist(), i, i, self.global_dims[i], dims[i],
                    rel.tolist(), hi)
                self._warned_clamp = True
                return

    def _read_hidden(self, model_state, batch):
        if not self.fusion_on:
            return None
        vols = model_state["global_hidden"].volumes
        rels = self._rel_origins(batch)
        dims = self._window_dims()
        return [read_windows_batch(vols[i], rels[i], dims[i])
                for i in range(self.n_layers)]

    def _write_hidden(self, model_state, batch, new_windows):
        if not self.fusion_on:
            return model_state
        vols = list(model_state["global_hidden"].volumes)
        rels = self._rel_origins(batch)
        for i in range(self.n_layers):
            # truncate cross-fragment backprop (gru_fusion.py:208-210)
            vols[i] = write_windows_batch(vols[i], new_windows[i].detach(),
                                          rels[i])
        return dict(model_state,
                    global_hidden=GlobalVolumeState(volumes=tuple(vols)))

    def _apply(self, params, model_state, batch):
        """``batch`` already on the device (``batch_to_device``)."""
        imgs = batch["imgs"]
        if imgs.dtype == torch.uint8:
            # images travel quantised; IMG_NORM = (mean, std) in [0,1] units
            mean, std = self.img_norm
            imgs = (imgs.float() / 255.0 - mean) / std
        if self.fusion_on and "scene_reset" in batch:
            reset = batch["scene_reset"].bool()
            dims = self._window_dims()
            if all(self.global_dims[i] == dims[i] for i in range(self.n_layers)):
                # windows cover the full extent: fold the reset into the read
                # window -- exact, since the write overwrites whole volumes
                hidden = self._read_hidden(model_state, batch)
                keep = (~reset).reshape((-1,) + (1,) * 4)
                hidden = [h * keep.to(h.dtype) for h in hidden]
            else:
                model_state = dict(model_state, global_hidden=reset_volumes(
                    model_state["global_hidden"], reset))
                hidden = self._read_hidden(model_state, batch)
        else:
            hidden = self._read_hidden(model_state, batch)
        out = params(imgs, batch["proj_matrices"], batch["vol_origin_partial"],
                     batch["world_to_aligned_camera"], hidden_windows=hidden)
        return out, self._write_hidden(model_state, batch, out["new_hidden"])

    # -- framework contract ------------------------------------------------
    def compute_level_loss(self, tsdf, occ, tsdf_target, occ_target, mask):
        """Masked per-level loss (neucon_network.py:216-260): the fused Triton
        kernel for CUDA tensors, its plain version for CPU tensors."""
        return fused_tsdf_occ_loss(tsdf.squeeze(-1), occ.squeeze(-1), tsdf_target,
                                   occ_target, mask, self.pos_weight)

    def loss_fn(self, params, model_state, batch, rng=None):
        """Training loss (parity: neuralrecon.py:754-771) with autograd on and
        the net in train mode.  Returns (total, {"log_vars": per-level
        losses, "model_state": the new state}); ``rng`` is unused, as in the
        JAX package.  The hidden write is detached (``_write_hidden``)."""
        batch = self.batch_to_device(batch)
        params.train()
        out, new_state = self._apply(params, model_state, batch)
        levels = []
        for i in range(self.n_layers):
            scale = self.n_layers - 1 - i
            mask = out["sparse_mask"][i]
            if not (self.fusion_on and self.fusion_full):
                # FULL fusion supervises the whole sparse set
                mask = mask & out["count_mask"][i]
            # squeeze, not [..., 0]: the gradient comes back as a view
            levels.append((out["tsdf"][i].squeeze(-1), out["occ"][i].squeeze(-1),
                           batch["tsdf_list"][scale], batch["occ_list"][scale],
                           mask))
        # every level in one Function: one backward launch on the card
        losses = fused_tsdf_occ_loss_levels(levels, self.pos_weight)
        total = 0.0
        log_vars = {}
        for i in range(self.n_layers):
            level_loss = losses[i, 0]
            total = total + self.lw[i] * level_loss
            log_vars[f"tsdf_occ_loss_{i}"] = level_loss
        return total, {"log_vars": log_vars, "model_state": new_state}

    @torch.no_grad()
    def val_fn(self, params, model_state, batch):
        batch = self.batch_to_device(batch)
        params.eval()
        out, _ = self._apply(params, model_state, batch)
        total = 0.0
        for i in range(self.n_layers):
            scale = self.n_layers - 1 - i
            # the mask is the sparse set alone (loss_fn also multiplies by
            # count_mask when FULL fusion is off; val_fn never does)
            level_loss, _, _ = self.compute_level_loss(
                out["tsdf"][i], out["occ"][i], batch["tsdf_list"][scale],
                batch["occ_list"][scale], out["sparse_mask"][i])
            total = total + self.lw[i] * level_loss
        return {"log_vars": {"loss": total}}

    @torch.no_grad()
    def forward_test(self, params, model_state, batch):
        """Inference: final-level dense tsdf + occupancy and the updated
        recurrent state (parity: neuralrecon.py:125-201 forward_test)."""
        batch = self.batch_to_device(batch)
        params.eval()
        out, new_state = self._apply(params, model_state, batch)
        tsdf = out["tsdf"][-1][..., 0]
        occ_logit = out["occ"][-1][..., 0]
        occupied = ((occ_logit > self.thresholds[-1])
                    & out["sparse_mask"][-1].bool())
        # unoccupied voxels read as empty space (tsdf=1) for meshing
        tsdf_masked = torch.where(occupied, tsdf, torch.ones_like(tsdf))
        return {
            "tsdf": tsdf_masked,
            "occ": torch.sigmoid(occ_logit),
            "origin": batch["vol_origin_partial"],
        }, new_state
