"""FAN face alignment: the stacked-hourglass landmark network and its
decoding (port of ``deep3dmap_tpu/models/face_alignment.py``).

``FAN`` runs on the card (GroupNorm through ``models/layers.py``, the
submodules named as flax names them, so a flax tree loads through
``utils/from_flax.py``).  The crop and the heatmap decode are host numpy,
as in JAX; the crop's resize is ``utils/image_ops.resize`` (OpenCV's
``INTER_LINEAR`` without ``cv2``).  Face detection is out of scope, as in
JAX: callers pass face boxes.
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils import image_ops
from ..utils.device import DeviceLike, resolve_device
from ..utils.from_flax import load_flax_npz, load_flax_params
from .layers import Conv, GroupNorm, init_flax_defaults


def _gn(channels: int) -> GroupNorm:
    groups = min(8, channels)
    while channels % groups:
        groups -= 1
    return GroupNorm(groups, channels)


class ConvBlock(nn.Module):
    """FAN residual block: 3 pre-activated convs over channel halves."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        f = features
        c1, c2, c3 = f // 2, f // 4, f - f // 2 - f // 4
        self.GroupNorm_0, self.Conv_0 = _gn(cin), Conv(cin, c1, (3, 3))
        self.GroupNorm_1, self.Conv_1 = _gn(c1), Conv(c1, c2, (3, 3))
        self.GroupNorm_2, self.Conv_2 = _gn(c2), Conv(c2, c3, (3, 3))
        if cin != f:
            self.GroupNorm_3, self.Conv_3 = _gn(cin), Conv(cin, f, (1, 1))

    def forward(self, x):
        out1 = self.Conv_0(F.relu(self.GroupNorm_0(x)))
        out2 = self.Conv_1(F.relu(self.GroupNorm_1(out1)))
        out3 = self.Conv_2(F.relu(self.GroupNorm_2(out2)))
        out = torch.cat([out1, out2, out3], dim=-1)
        if hasattr(self, "Conv_3"):
            x = self.Conv_3(F.relu(self.GroupNorm_3(x)))
        return out + x


def _avg_pool2(x):
    return F.avg_pool2d(x.movedim(-1, 1), 2, 2).movedim(1, -1)


class Hourglass(nn.Module):
    """Recursive hourglass: downsample, recurse, upsample, add the skip."""

    def __init__(self, depth: int = 3, features: int = 128):
        super().__init__()
        f = features
        self.depth = depth
        self.ConvBlock_0, self.ConvBlock_1 = ConvBlock(f, f), ConvBlock(f, f)
        if depth > 1:
            self.Hourglass_0 = Hourglass(depth - 1, f)
            self.ConvBlock_2 = ConvBlock(f, f)
        else:
            self.ConvBlock_2, self.ConvBlock_3 = ConvBlock(f, f), ConvBlock(f, f)

    def forward(self, x):
        up1 = self.ConvBlock_0(x)
        low = self.ConvBlock_1(_avg_pool2(x))
        if self.depth > 1:
            low = self.ConvBlock_2(self.Hourglass_0(low))
        else:
            low = self.ConvBlock_3(self.ConvBlock_2(low))
        # jax.image.resize "nearest" by an exact factor 2 repeats each pixel
        # (the maps are 64, 32, 16 and 8 wide)
        return up1 + low.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class FAN(nn.Module):
    """(B, 256, 256, 3) in [0, 1] -> (B, n_modules, 64, 64, n_landmarks)
    heatmaps (the last module's map is the prediction)."""

    def __init__(self, n_modules: int = 2, n_landmarks: int = 68, features: int = 128,
                 hg_depth: int = 3):
        super().__init__()
        f = features
        self.n_modules = n_modules
        self.Conv_0 = Conv(3, f // 2, (7, 7), strides=2)
        self.GroupNorm_0 = _gn(f // 2)
        self.ConvBlock_0 = ConvBlock(f // 2, f)
        self.ConvBlock_1 = ConvBlock(f, f)
        self.ConvBlock_2 = ConvBlock(f, f)
        conv = 1
        for i in range(n_modules):
            setattr(self, f"Hourglass_{i}", Hourglass(hg_depth, f))
            setattr(self, f"ConvBlock_{3 + i}", ConvBlock(f, f))
            setattr(self, f"GroupNorm_{1 + i}", _gn(f))
            setattr(self, f"Conv_{conv}", Conv(f, f, (1, 1)))
            setattr(self, f"Conv_{conv + 1}", Conv(f, n_landmarks, (1, 1)))
            conv += 2
            if i < n_modules - 1:
                setattr(self, f"Conv_{conv}", Conv(f, f, (1, 1)))
                setattr(self, f"Conv_{conv + 1}", Conv(n_landmarks, f, (1, 1)))
                conv += 2

    def forward(self, x):
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))                  # 128
        x = _avg_pool2(self.ConvBlock_0(x))                            # 64
        prev = self.ConvBlock_2(self.ConvBlock_1(x))
        outputs, conv = [], 1
        for i in range(self.n_modules):
            hg = getattr(self, f"ConvBlock_{3 + i}")(getattr(self, f"Hourglass_{i}")(prev))
            hg = F.relu(getattr(self, f"GroupNorm_{1 + i}")(getattr(self, f"Conv_{conv}")(hg)))
            heat = getattr(self, f"Conv_{conv + 1}")(hg)
            outputs.append(heat)
            conv += 2
            if i < self.n_modules - 1:
                prev = (prev + getattr(self, f"Conv_{conv}")(hg)
                        + getattr(self, f"Conv_{conv + 1}")(heat))
                conv += 2
        return torch.stack(outputs, dim=1)


# ---------------------------------------------------------------- host side
def transform_point(point, center, scale, resolution: float,
                    invert: bool = False) -> np.ndarray:
    """Map a point between original-image space and the crop's
    ``resolution`` x ``resolution`` space."""
    pt = np.array([point[0], point[1], 1.0])
    h = 200.0 * scale
    t = np.eye(3)
    t[0, 0] = resolution / h
    t[1, 1] = resolution / h
    t[0, 2] = resolution * (-center[0] / h + 0.5)
    t[1, 2] = resolution * (-center[1] / h + 0.5)
    if invert:
        t = np.linalg.inv(t)
    return (t @ pt)[:2]


def crop_face(image: np.ndarray, center, scale, resolution: int = 256) -> np.ndarray:
    """Crop the face region, zero-padded past the border, and resize it to
    resolution² (``INTER_LINEAR``)."""
    ul = transform_point([1, 1], center, scale, resolution, invert=True).astype(int)
    br = transform_point([resolution, resolution], center, scale, resolution,
                         invert=True).astype(int)
    ht, wd = image.shape[:2]
    new = np.zeros((br[1] - ul[1], br[0] - ul[0]) + image.shape[2:], image.dtype)
    sy0, sy1 = max(0, ul[1]), min(ht, br[1])
    sx0, sx1 = max(0, ul[0]), min(wd, br[0])
    dy0, dx0 = max(0, -ul[1]), max(0, -ul[0])
    new[dy0:dy0 + (sy1 - sy0), dx0:dx0 + (sx1 - sx0)] = image[sy0:sy1, sx0:sx1]
    return image_ops.resize(new, (resolution, resolution))


def draw_gaussian(image: np.ndarray, point, sigma: float = 1.0) -> np.ndarray:
    """Render a gaussian blob at ``point`` into the heatmap ``image`` (the
    training targets), in place."""
    size = int(6 * sigma + 1)
    g1 = np.arange(size) - (size - 1) / 2
    gx, gy = np.meshgrid(g1, g1)
    g = np.exp(-(gx ** 2 + gy ** 2) / (2 * sigma ** 2))
    ul = [int(point[0] - 3 * sigma), int(point[1] - 3 * sigma)]
    br = [ul[0] + size, ul[1] + size]
    H, W = image.shape
    gx0, gy0 = max(0, -ul[0]), max(0, -ul[1])
    gx1 = size - max(0, br[0] - W)
    gy1 = size - max(0, br[1] - H)
    ix0, iy0 = max(0, ul[0]), max(0, ul[1])
    ix1, iy1 = min(W, br[0]), min(H, br[1])
    if ix1 <= ix0 or iy1 <= iy0:
        return image
    image[iy0:iy1, ix0:ix1] = np.maximum(image[iy0:iy1, ix0:ix1], g[gy0:gy1, gx0:gx1])
    return image


def get_preds_from_heatmaps(hm: np.ndarray, centers=None, scales=None):
    """Heatmaps (B, H, W, L) -> landmark coordinates with the ±0.25 px
    sub-pixel step toward the larger neighbour, and, given the crops'
    centres and scales, the same in original-image space.  Returns
    (coords_in_hm, coords_orig)."""
    hm = np.asarray(hm)
    B, H, W, L = hm.shape
    flat = hm.transpose(0, 3, 1, 2).reshape(B, L, -1)
    idx = flat.argmax(axis=-1)
    xs = (idx % W).astype(np.float64)
    ys = (idx // W).astype(np.float64)
    for b in range(B):
        for lm in range(L):
            x, y = int(xs[b, lm]), int(ys[b, lm])
            m = hm[b, :, :, lm]
            if 0 < x < W - 1:
                xs[b, lm] += 0.25 * np.sign(m[y, x + 1] - m[y, x - 1])
            if 0 < y < H - 1:
                ys[b, lm] += 0.25 * np.sign(m[y + 1, x] - m[y - 1, x])
    preds = np.stack([xs, ys], axis=-1) + 0.5  # (B, L, 2), pixel-centre offset
    if centers is None:
        return preds, preds.copy()
    orig = np.zeros_like(preds)
    for b in range(B):
        for lm in range(L):
            orig[b, lm] = transform_point(preds[b, lm], centers[b], scales[b], H,
                                          invert=True)
    return preds, orig


class FaceAlignment:
    """Landmarks from face boxes through a FAN on ``device`` (``None``: the
    card, raising without one; ``"cpu"`` by name).  ``params`` is a flax
    tree (nested numpy arrays, optionally under ``"params"``) or the path of
    an ``.npz`` holding one under ``params``; without it the FAN takes the
    port's seeded init."""

    def __init__(self, n_modules: int = 2, n_landmarks: int = 68,
                 params: Optional[Union[Mapping, str]] = None, seed: int = 0,
                 resolution: int = 256, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.resolution = resolution
        self.net = FAN(n_modules=n_modules, n_landmarks=n_landmarks).eval()
        if params is None:
            init_flax_defaults(self.net, torch.Generator().manual_seed(int(seed)))
        elif isinstance(params, str):
            load_flax_npz(self.net, params)
        else:
            load_flax_params(self.net, params)
        self.net.to(self.device)

    @torch.no_grad()
    def heatmaps(self, crops: np.ndarray) -> torch.Tensor:
        """Crops (B, R, R, 3) in [0, 1] -> the last module's heatmaps
        (B, R/4, R/4, L) on the device."""
        return self.net(torch.from_numpy(np.ascontiguousarray(crops, np.float32))
                        .to(self.device))[:, -1]

    def get_landmarks_from_image(self, image: np.ndarray,
                                 detected_faces: Sequence[Sequence[float]]) -> List[np.ndarray]:
        """image (H, W, 3) uint8 or float; ``detected_faces``: [x1, y1, x2,
        y2] boxes.  Returns a (L, 2) landmark array per face in image
        space."""
        image = np.asarray(image)
        if image.dtype == np.uint8:
            image = image.astype(np.float32) / 255.0
        crops, centers, scales = [], [], []
        for (x1, y1, x2, y2) in detected_faces:
            center = np.array([(x1 + x2) / 2.0, (y1 + y2) / 2.0 - (y2 - y1) * 0.12])
            scale = (x2 - x1 + y2 - y1) / 195.0
            crops.append(crop_face(image, center, scale, self.resolution))
            centers.append(center)
            scales.append(scale)
        hms = self.heatmaps(np.stack(crops)).float().cpu().numpy()
        _, orig = get_preds_from_heatmaps(hms, centers, scales)
        return [orig[i] for i in range(len(detected_faces))]
