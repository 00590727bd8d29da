"""LERF's ray datamanager: posed images -> ray batches with CLIP-pyramid and
DINO targets (port of ``deep3dmap_tpu/datasets/lerf_rays.py``).

- CLIP pyramid: per tile scale, overlapping square crops (kernel
  tile_ratio x H, stride stride_ratio x kernel, padding kernel // 2), each
  resized to the encoder's input (``jax.image.resize`` bilinear,
  ``ops/resize.py``), embedded and normalised into a grid of crop centres;
  a pixel query blends its four neighbouring crops bilinearly, and the
  scale axis is a random bin plus a lerp between adjacent tile scales,
  returned as the normalised scale.
- DINO: per-patch descriptors of a DINO ViT (``dino_npz``, or the seeded
  architecture, ``dino_pretrained = False``), queried at the nearest patch.

The encoders run on the dataset's ``device`` (CUDA unless ``"cpu"``); the
embedding grids come back to the host, where the queries run in numpy as
in JAX.  The same encoders and ``seed`` give JAX's batches: the same
``RandomState`` draws in the same order and the same crop loop.  Batches
are host numpy dicts (``rays_o``, ``rays_d``, ``rgb``, ``clip``, ``dino``,
``clip_scales``); the runner's prefetch uploads them.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.resize import resize_bilinear
from ..utils.device import DeviceLike, resolve_device
from .builder import DATASETS

EMBED_CHUNK = 256       # crops per encoder call: bounds the ViT's activations


def _embed_crops(encoder, crops01: np.ndarray) -> np.ndarray:
    """[0, 1] crops (N, k, k, 3) -> L2-normalised embeddings (N, D), host
    float32.  The compact ``CLIPEncoder`` takes 64² crops; a ``CLIPViT`` (or
    a ``CLIPEncoder`` holding one) takes its ``image_size`` with CLIP's
    normalisation."""
    vit = encoder if hasattr(encoder, "visual") else getattr(encoder, "_vit", None)
    res = vit.visual.image_size if vit is not None else 64
    out = []
    for i in range(0, len(crops01), EMBED_CHUNK):
        x = torch.from_numpy(np.ascontiguousarray(crops01[i:i + EMBED_CHUNK], np.float32))
        x = x.to(encoder.device)
        if x.shape[1] != res or x.shape[2] != res:
            x = resize_bilinear(x, res)
        if vit is not None:
            x = vit.preprocess(x)
        out.append(encoder.encode_image(x).float().cpu().numpy())
    e = np.concatenate(out)
    return e / (np.linalg.norm(e, axis=-1, keepdims=True) + 1e-9)


class PatchEmbeddingGrid:
    """One tile scale: the overlapping crops' embedding grid and its bilinear
    query.  Crop centres sit at (k-1)/2 - pad + stride x i; the grid gets an
    edge-duplicate row and column, so the upper neighbour always exists."""

    def __init__(self, images01: Sequence[np.ndarray], encoder, tile_ratio: float,
                 stride_ratio: float):
        H, W = images01[0].shape[:2]
        self.k = max(int(H * tile_ratio), 2)
        self.stride = max(int(self.k * stride_ratio), 1)
        pad = self.k // 2
        self.pad = pad

        def centers(size):
            n = int(np.floor((size + 2 * pad - (self.k - 1) - 1) / self.stride + 1))
            return (self.k - 1) / 2 - pad + self.stride * np.arange(n)

        self.center_r = centers(H)
        self.center_c = centers(W)
        grids = []
        for img in images01:
            p = np.pad(np.asarray(img, np.float32), ((pad, pad), (pad, pad), (0, 0)))
            crops = [p[r0:r0 + self.k, c0:c0 + self.k]
                     for r0 in range(0, H + 2 * pad - self.k + 1, self.stride)
                     for c0 in range(0, W + 2 * pad - self.k + 1, self.stride)]
            e = _embed_crops(encoder, np.stack(crops))
            g = e.reshape(len(self.center_r), len(self.center_c), -1)
            g = np.concatenate([g, g[:, -1:]], axis=1)
            g = np.concatenate([g, g[-1:]], axis=0)
            grids.append(g)
        self.data = np.stack(grids)      # (n_img, R+1, C+1, D)

    @property
    def n_crops(self) -> int:
        return len(self.center_r) * len(self.center_c)

    def query(self, img_idx: np.ndarray, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        r_ind = np.clip(np.searchsorted(self.center_r, rows, side="left") - 1,
                        0, len(self.center_r) - 1)
        c_ind = np.clip(np.searchsorted(self.center_c, cols, side="left") - 1,
                        0, len(self.center_c) - 1)
        tl = self.data[img_idx, r_ind, c_ind]
        tr = self.data[img_idx, r_ind, c_ind + 1]
        bl = self.data[img_idx, r_ind + 1, c_ind]
        br = self.data[img_idx, r_ind + 1, c_ind + 1]
        wc = ((cols - self.center_c[c_ind]) / self.stride)[:, None]
        wr = ((rows - self.center_r[r_ind]) / self.stride)[:, None]
        top = tl + (tr - tl) * wc
        bot = bl + (br - bl) * wc
        return top + (bot - top) * wr


class PyramidEmbeddings:
    """The tile scales' ``PatchEmbeddingGrid``s and the random-scale query."""

    def __init__(self, images01, encoder, tile_size_range=(0.15, 0.6),
                 tile_size_res: int = 3, stride_scaler: float = 0.5):
        self.tile_sizes = np.linspace(tile_size_range[0], tile_size_range[1], tile_size_res)
        self.levels: List[PatchEmbeddingGrid] = []
        for tr in self.tile_sizes:
            # the reference's stride scaler: interp(tile, [.05, .15], [1, stride_scaler])
            ss = float(np.interp(tr, [0.05, 0.15], [1.0, stride_scaler]))
            self.levels.append(PatchEmbeddingGrid(images01, encoder, tr, ss))

    def sample_random_scales(self, rs: np.random.RandomState, img_idx, rows, cols):
        """(embeddings (B, D), scales (B,)): a random bin per query and a lerp
        between its two tile scales, as the reference's ``_random_scales``."""
        n = len(rows)
        nbin = len(self.tile_sizes) - 1
        sbin = rs.randint(0, max(nbin, 1), n)
        w = rs.rand(n).astype(np.float32)
        step = ((self.tile_sizes[1] - self.tile_sizes[0])
                / (self.tile_sizes[-1] - self.tile_sizes[0])) if nbin else 1.0
        bottom = np.zeros((n, self.levels[0].data.shape[-1]), np.float32)
        top = np.zeros_like(bottom)
        for i in range(max(nbin, 1)):
            m = sbin == i
            if not m.any():
                continue
            bottom[m] = self.levels[i].query(img_idx[m], rows[m], cols[m])
            top[m] = self.levels[min(i + 1, len(self.levels) - 1)].query(
                img_idx[m], rows[m], cols[m])
        emb = bottom + (top - bottom) * w[:, None]
        emb /= np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-9
        scales = (sbin * step + w * step).astype(np.float32)
        return emb, scales


@DATASETS.register_module()
class LERFRayDataset:
    """An iterable of ray batches over a posed-image dataset (no
    ``__getitem__``: ``build_dataloader`` passes it through).  Every rank
    iterates the same seeded batches: ``global_batch`` tells the runner to
    keep each rank's slice of them (``shard_batch(global_batch=True)``)."""

    global_batch = True

    def __init__(self, image_dataset: Optional[dict] = None, rays_per_batch: int = 256,
                 n_batches: int = 16, clip_n_dims: int = 512, dino_n_dims: int = 384,
                 tile_size_range=(0.15, 0.6), tile_size_res: int = 3,
                 stride_scaler: float = 0.5, seed: int = 0, image_encoder=None,
                 clip_npz: Optional[str] = None, dino_npz: Optional[str] = None,
                 dino_layer: int = 11, dino_facet: str = "key", pipeline=None,
                 device: DeviceLike = None):
        from .builder import build_dataset
        from .nerf_synthetic import SyntheticNerfDataset

        self.device = resolve_device(device)
        self.base = (build_dataset(image_dataset, default_args=dict(device=self.device))
                     if image_dataset is not None
                     else SyntheticNerfDataset(n_images=4, img_wh=(32, 32), device=self.device))
        self.rays_per_batch = rays_per_batch
        self.n_batches = n_batches
        self.clip_n_dims = clip_n_dims
        self.dino_n_dims = dino_n_dims
        self.tile_size_range = tuple(tile_size_range)
        self.tile_size_res = tile_size_res
        self.stride_scaler = stride_scaler
        self.seed = seed
        self._encoder = image_encoder
        self._clip_npz = clip_npz
        self._dino_npz = dino_npz
        self._dino_layer = dino_layer
        self._dino_facet = dino_facet
        self._pyramid: Optional[PyramidEmbeddings] = None
        self._dino_maps = None

    def _build_encoder(self):
        if self._encoder is not None:
            return self._encoder
        if self._clip_npz:
            from ..models.modulars.clip_vit import CLIPViT
            self._encoder = CLIPViT.from_npz(self._clip_npz, device=self.device)
        else:
            from ..models.modulars.clip_encoder import CLIPEncoder
            self._encoder = CLIPEncoder(embed_dim=self.clip_n_dims, device=self.device)
        return self._encoder

    def _precompute(self):
        """The CLIP pyramid and the DINO maps of every image (the reference's
        pyramid and DINO dataloaders)."""
        imgs01 = self.images01()
        self.build_pyramid(imgs01)
        self.build_dino(imgs01)

    def images01(self) -> List[np.ndarray]:
        return [np.clip((np.asarray(im) + 1) / 2, 0, 1) for im in self.base.images]

    def build_pyramid(self, imgs01) -> None:
        self._pyramid = PyramidEmbeddings(imgs01, self._build_encoder(), self.tile_size_range,
                                          self.tile_size_res, self.stride_scaler)

    def build_dino(self, imgs01) -> None:
        from ..models.modulars.dino_vit import DinoExtractor

        if self._dino_npz:
            dino = DinoExtractor.from_npz(self._dino_npz, layer=self._dino_layer,
                                          facet=self._dino_facet, device=self.device)
        else:
            dino = DinoExtractor(cfg=dict(dim=self.dino_n_dims,
                                          heads=max(self.dino_n_dims // 64, 1)),
                                 layer=self._dino_layer, facet=self._dino_facet,
                                 device=self.device)
        self.dino_pretrained = dino.pretrained
        self._dino_maps = dino.extract(np.stack(imgs01)).float().cpu().numpy()

    def _rays_for(self, img_idx, ys, xs):
        K = self.base.intrinsics
        pose = self.base.poses[img_idx]
        dirs = np.stack([(xs - K[0, 2]) / K[0, 0], -(ys - K[1, 2]) / K[1, 1],
                         -np.ones_like(xs, np.float32)], -1)
        rays_d = dirs @ pose[:3, :3].T
        rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
        rays_o = np.broadcast_to(pose[:3, 3], rays_d.shape)
        return rays_o.astype(np.float32), rays_d.astype(np.float32)

    def __len__(self):
        return self.n_batches

    def __iter__(self):
        if self._pyramid is None:
            self._precompute()
        W, H = self.base.img_wh
        dh, dw = self._dino_maps.shape[1:3]
        rs = np.random.RandomState(self.seed)
        for _ in range(self.n_batches):
            n = self.rays_per_batch
            img_idx = rs.randint(0, len(self.base))
            ys = rs.randint(0, H, n)
            xs = rs.randint(0, W, n)
            rays_o, rays_d = self._rays_for(img_idx, ys.astype(np.float32),
                                            xs.astype(np.float32))
            img = np.asarray(self.base.images[img_idx])
            clip_emb, clip_scales = self._pyramid.sample_random_scales(
                rs, np.full(n, img_idx), ys.astype(np.float32), xs.astype(np.float32))
            # DINO: the nearest patch-grid texel
            dr = np.minimum((ys * dh / H).astype(np.int64), dh - 1)
            dc = np.minimum((xs * dw / W).astype(np.int64), dw - 1)
            yield dict(rays_o=rays_o, rays_d=rays_d, rgb=img[ys, xs].astype(np.float32),
                       clip=clip_emb, dino=self._dino_maps[img_idx][dr, dc],
                       clip_scales=clip_scales)
