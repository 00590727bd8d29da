"""DINO Vision Transformer feature extractor, ViT-S/8 by default (port of
``deep3dmap_tpu/models/modulars/dino_vit.py``): dense per-patch descriptors
of a DINO ViT, the keys of a chosen attention layer with the heads
concatenated, LERF's DINO target.

  conv patch embed (p x p, stride p) -> [CLS; patches] + position embedding
  -> L x (norm1 -> MHA (fused qkv) -> residual -> norm2 -> MLP (exact GELU)
  -> residual) -> norm

For another token grid than the checkpoint's, the patch position embedding
is resized as JAX's ``jax.image.resize(..., "bicubic")`` does: Keys' cubic
at a = -0.5 with JAX's edge weights and antialiasing (``ops/resize.py``),
not ``F.interpolate``'s a = -0.75.  Checkpoints load key for key through
``utils/torch_import.py::import_dino``; without one the extractor runs the
same architecture seeded, labelled ``pretrained = False``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.resize import resize_bicubic
from ...utils.device import DeviceLike, resolve_device
from ..layers import Conv, Dense, LayerNorm, init_flax_defaults
from .clip_vit import _attend

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class DinoBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.fc1 = Dense(dim, mlp_ratio * dim)
        self.fc2 = Dense(mlp_ratio * dim, dim)

    def forward(self, x: torch.Tensor, capture: Optional[str] = None):
        """(x, captured): the facet ``capture`` ('key', 'query', 'value',
        'attn' or 'token') of this block, or None."""
        q, k, v = self.qkv(self.norm1(x)).chunk(3, -1)
        captured = {"key": k, "query": q, "value": v}.get(capture)
        out, att = _attend(q, k, v, self.heads)
        if capture == "attn":
            captured = torch.softmax(att, -1)
        x = x + self.proj(out)
        x = x + self.fc2(F.gelu(self.fc1(self.norm2(x))))
        return x, (x if capture == "token" else captured)


class DinoViT(nn.Module):
    """img (B, H, W, 3) -> (patch facet (B, h, w, dim'), CLS embedding
    (B, dim)); the facet is taken at block ``layer`` (past the last block:
    the normalised tokens)."""

    FLAX_LEAVES = {"cls_token": ("cls_token", "plain"), "pos_embed": ("pos_embed", "plain")}

    def __init__(self, patch_size: int = 8, dim: int = 384, depth: int = 12, heads: int = 6,
                 mlp_ratio: int = 4, base_grid: int = 28):
        super().__init__()
        self.patch_size, self.dim, self.depth, self.base_grid = patch_size, dim, depth, base_grid
        self.patch_embed = Conv(3, dim, (patch_size, patch_size), strides=patch_size,
                                padding="VALID")
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + base_grid ** 2, dim))
        for i in range(depth):
            setattr(self, f"block{i}", DinoBlock(dim, heads, mlp_ratio))
        self.norm = LayerNorm(dim, eps=1e-6)

    def init_raw(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            for p in (self.cls_token, self.pos_embed):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)

    def forward(self, img: torch.Tensor, layer: int = 11, facet: str = "key"):
        B = img.shape[0]
        x = self.patch_embed(img)
        h, w = x.shape[1], x.shape[2]
        x = x.reshape(B, h * w, self.dim)
        pos_cls, pos_patch = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (h, w) != (self.base_grid, self.base_grid):
            g = self.base_grid
            pos_patch = resize_bicubic(pos_patch.reshape(1, g, g, self.dim), (h, w))
            pos_patch = pos_patch.reshape(1, h * w, self.dim)
        x = torch.cat([(self.cls_token + pos_cls).expand(B, 1, self.dim), x + pos_patch], 1)
        captured = None
        for i in range(self.depth):
            x, cap = getattr(self, f"block{i}")(x, capture=facet if i == layer else None)
            if cap is not None:
                captured = cap
        x = self.norm(x)
        if captured is None:
            captured = x
        return captured[:, 1:].reshape(B, h, w, -1), x[:, 0]


class DinoExtractor:
    """Preprocessing and dense-descriptor extraction on ``device`` (CUDA
    unless ``"cpu"``).  ``params=None`` seeds the architecture (``seed``);
    real runs load an imported checkpoint with ``from_npz``."""

    def __init__(self, params=None, cfg: Optional[Dict[str, Any]] = None, layer: int = 11,
                 facet: str = "key", seed: int = 0, device: DeviceLike = None):
        from ...utils.from_flax import load_flax_params

        self.device = resolve_device(device)
        self.cfg = dict(patch_size=8, dim=384, depth=12, heads=6, mlp_ratio=4, base_grid=28)
        if cfg:
            self.cfg.update(cfg)
        self.layer, self.facet = layer, facet
        self.net = DinoViT(**self.cfg)
        self.pretrained = params is not None
        if params is None:
            init_flax_defaults(self.net, torch.Generator().manual_seed(int(seed)))
        else:
            load_flax_params(self.net, params)
        self.net.to(self.device).requires_grad_(False)

    @classmethod
    def from_npz(cls, path: str, layer: int = 11, facet: str = "key",
                 device: DeviceLike = None) -> "DinoExtractor":
        """An imported checkpoint (``tools/import_weights.py dino``: ``params``
        a flax tree, ``meta`` the config)."""
        with np.load(path, allow_pickle=True) as data:
            cfg = data["meta"].item() if "meta" in data.files else None
            params = data["params"].item()
        return cls(params=params, cfg=cfg, layer=layer, facet=facet, device=device)

    @property
    def embed_dim(self) -> int:
        return self.cfg["dim"]

    def preprocess(self, imgs01) -> torch.Tensor:
        """[0, 1] RGB (B, H, W, 3) -> ImageNet-normalised, cropped to whole
        patches, on the device."""
        x = torch.as_tensor(np.asarray(imgs01, np.float32)).to(self.device)
        x = (x - torch.from_numpy(IMAGENET_MEAN).to(self.device)) \
            / torch.from_numpy(IMAGENET_STD).to(self.device)
        p = self.cfg["patch_size"]
        H, W = x.shape[1], x.shape[2]
        return x[:, :H - H % p, :W - W % p]

    @torch.no_grad()
    def extract(self, imgs01) -> torch.Tensor:
        """[0, 1] images -> (B, h, w, dim) patch-grid descriptors on the
        device."""
        return self.net(self.preprocess(imgs01), layer=self.layer, facet=self.facet)[0]
