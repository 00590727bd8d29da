"""Instance mask structures: ``BitmapMasks`` and ``PolygonMasks`` (the
port's copy of ``deep3dmap_tpu/utils/mask_structures.py``).

Host-side numpy containers, as in the JAX package: masks are a dataset
preparation artifact, and ``to_ndarray`` is where they leave for the device
(a stacked ``uint8`` array uploaded with the batch).  Resize, flip, crop and
the affine maps use numpy nearest-neighbour resampling, the scanline fill
``_rasterize`` and ``_affine_nearest`` op for op as JAX has them, so the
masks are equal bit for bit; no OpenCV.
"""
from __future__ import annotations

import itertools
from typing import List, Sequence

import numpy as np


def _resize_nearest(mask: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w = mask.shape[-2:]
    ys = np.clip((np.arange(out_h) + 0.5) * h / out_h, 0, h - 1).astype(int)
    xs = np.clip((np.arange(out_w) + 0.5) * w / out_w, 0, w - 1).astype(int)
    return mask[..., ys[:, None], xs[None, :]]


def _affine_nearest(mask: np.ndarray, mat: np.ndarray, out_h: int,
                    out_w: int, fill_val=0) -> np.ndarray:
    """Apply 2x3 affine (output->input implied by inverse) per mask."""
    inv = np.linalg.inv(np.vstack([mat, [0, 0, 1]]))[:2]
    yy, xx = np.meshgrid(np.arange(out_h), np.arange(out_w), indexing="ij")
    src_x = inv[0, 0] * xx + inv[0, 1] * yy + inv[0, 2]
    src_y = inv[1, 0] * xx + inv[1, 1] * yy + inv[1, 2]
    xi = np.round(src_x).astype(int)
    yi = np.round(src_y).astype(int)
    h, w = mask.shape[-2:]
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = np.full(mask.shape[:-2] + (out_h, out_w), fill_val, mask.dtype)
    out[..., valid] = mask[..., yi[valid], xi[valid]]
    return out


class BitmapMasks:
    """Masks as a dense (N, H, W) uint8 array (mask_structures.py:199)."""

    def __init__(self, masks, height: int, width: int):
        self.height = height
        self.width = width
        if len(masks) == 0:
            self.masks = np.empty((0, height, width), np.uint8)
        else:
            if isinstance(masks, (list, tuple)):
                masks = np.stack(masks)
            assert masks.ndim == 3
            assert masks.shape[1:] == (height, width), (
                f"{masks.shape} vs ({height}, {width})")
            self.masks = masks.astype(np.uint8)

    def __getitem__(self, index):
        m = self.masks[index].reshape(-1, self.height, self.width)
        return BitmapMasks(m, self.height, self.width)

    def __iter__(self):
        return iter(self.masks)

    def __len__(self):
        return len(self.masks)

    def __repr__(self):
        return (f"{type(self).__name__}(num_masks={len(self)}, "
                f"height={self.height}, width={self.width})")

    def rescale(self, scale, interpolation="nearest"):
        if isinstance(scale, (int, float)):
            new_h, new_w = int(round(self.height * scale)), int(
                round(self.width * scale))
        else:
            # mmcv rescale_size semantics: scale=(max_long, max_short)
            max_long, max_short = max(scale), min(scale)
            f = min(max_long / max(self.height, self.width),
                    max_short / min(self.height, self.width))
            new_h, new_w = int(self.height * f + 0.5), int(self.width * f + 0.5)
        return self.resize((new_h, new_w), interpolation)

    def resize(self, out_shape, interpolation="nearest"):
        out_h, out_w = out_shape
        if len(self.masks) == 0:
            return BitmapMasks(np.empty((0, out_h, out_w), np.uint8),
                               out_h, out_w)
        return BitmapMasks(_resize_nearest(self.masks, out_h, out_w),
                           out_h, out_w)

    def flip(self, flip_direction="horizontal"):
        assert flip_direction in ("horizontal", "vertical", "diagonal")
        if flip_direction == "horizontal":
            flipped = self.masks[:, :, ::-1]
        elif flip_direction == "vertical":
            flipped = self.masks[:, ::-1, :]
        else:
            flipped = self.masks[:, ::-1, ::-1]
        return BitmapMasks(np.ascontiguousarray(flipped),
                           self.height, self.width)

    def pad(self, out_shape, pad_val=0):
        out_h, out_w = out_shape
        padded = np.full((len(self), out_h, out_w), pad_val, np.uint8)
        padded[:, :self.height, :self.width] = self.masks
        return BitmapMasks(padded, out_h, out_w)

    def crop(self, bbox):
        bbox = np.asarray(bbox).copy()
        assert bbox.ndim == 1
        bbox[0::2] = np.clip(bbox[0::2], 0, self.width)
        bbox[1::2] = np.clip(bbox[1::2], 0, self.height)
        x1, y1, x2, y2 = bbox.astype(int)
        w = max(x2 - x1, 1)
        h = max(y2 - y1, 1)
        if len(self.masks) == 0:
            cropped = np.empty((0, h, w), np.uint8)
        else:
            cropped = self.masks[:, y1:y1 + h, x1:x1 + w]
        return BitmapMasks(cropped, h, w)

    def crop_and_resize(self, bboxes, out_shape, inds, device=None,
                        interpolation="bilinear"):
        if len(self.masks) == 0:
            return BitmapMasks(
                np.empty((0,) + tuple(out_shape), np.uint8), *out_shape)
        out = []
        for bbox, i in zip(np.asarray(bboxes), np.asarray(inds)):
            x1, y1, x2, y2 = np.clip(
                bbox, 0, [self.width, self.height] * 2).astype(int)
            patch = self.masks[int(i), y1:max(y2, y1 + 1),
                               x1:max(x2, x1 + 1)]
            out.append(_resize_nearest(patch, *out_shape))
        return BitmapMasks(np.stack(out), *out_shape)

    def expand(self, expanded_h, expanded_w, top, left):
        expanded = np.zeros((len(self), expanded_h, expanded_w), np.uint8)
        expanded[:, top:top + self.height, left:left + self.width] = self.masks
        return BitmapMasks(expanded, expanded_h, expanded_w)

    def translate(self, out_shape, offset, direction="horizontal",
                  fill_val=0, interpolation=None):
        mat = np.array([[1, 0, offset if direction == "horizontal" else 0],
                        [0, 1, offset if direction == "vertical" else 0]],
                       np.float64)
        return BitmapMasks(
            _affine_nearest(self.masks, mat, *out_shape, fill_val=fill_val),
            *out_shape)

    def shear(self, out_shape, magnitude, direction="horizontal",
              border_value=0, interpolation=None):
        if direction == "horizontal":
            mat = np.array([[1, magnitude, 0], [0, 1, 0]], np.float64)
        else:
            mat = np.array([[1, 0, 0], [magnitude, 1, 0]], np.float64)
        return BitmapMasks(
            _affine_nearest(self.masks, mat, *out_shape,
                            fill_val=border_value), *out_shape)

    def rotate(self, out_shape, angle, center=None, scale=1.0, fill_val=0):
        if center is None:
            center = ((self.width - 1) * 0.5, (self.height - 1) * 0.5)
        rad = np.deg2rad(angle)
        cos, sin = np.cos(rad) * scale, np.sin(rad) * scale
        cx, cy = center
        mat = np.array([[cos, sin, (1 - cos) * cx - sin * cy],
                        [-sin, cos, sin * cx + (1 - cos) * cy]], np.float64)
        return BitmapMasks(
            _affine_nearest(self.masks, mat, *out_shape, fill_val=fill_val),
            *out_shape)

    @property
    def areas(self):
        return self.masks.sum((1, 2))

    def to_ndarray(self):
        return self.masks

    def get_bboxes(self):
        num = len(self)
        boxes = np.zeros((num, 4), np.float32)
        xs = np.any(self.masks, axis=1)
        ys = np.any(self.masks, axis=2)
        for i in range(num):
            x = np.where(xs[i])[0]
            y = np.where(ys[i])[0]
            if len(x):
                boxes[i] = [x[0], y[0], x[-1] + 1, y[-1] + 1]
        return boxes

    @classmethod
    def random(cls, num_masks=3, height=32, width=32, dtype=np.uint8,
               rng=None):
        rng = rng or np.random.RandomState(0)
        masks = (rng.rand(num_masks, height, width) > 0.8).astype(dtype)
        return cls(masks, height, width)


class PolygonMasks:
    """Masks as per-instance polygon lists (mask_structures.py:554).

    ``masks`` is list[list[ndarray(2k,)]] — each instance is a list of
    flattened xy polygons.
    """

    def __init__(self, masks: List[List[np.ndarray]], height: int, width: int):
        assert isinstance(masks, list)
        if len(masks) > 0:
            assert isinstance(masks[0], list)
        self.height = height
        self.width = width
        self.masks = [[np.asarray(p, np.float32) for p in poly]
                      for poly in masks]

    def __getitem__(self, index):
        if isinstance(index, np.ndarray):
            index = index.tolist()
        if isinstance(index, list):
            masks = [self.masks[i] for i in index]
        else:
            try:
                masks = self.masks[index]
                if not isinstance(masks[0], list):
                    masks = [masks]
            except Exception:
                raise ValueError(
                    f"Unsupported input of type {type(index)} for indexing!")
        return PolygonMasks(masks, self.height, self.width)

    def __iter__(self):
        return iter(self.masks)

    def __len__(self):
        return len(self.masks)

    def __repr__(self):
        return (f"{type(self).__name__}(num_masks={len(self)}, "
                f"height={self.height}, width={self.width})")

    def rescale(self, scale, interpolation=None):
        if isinstance(scale, (int, float)):
            hs = ws = scale
            new_h = int(round(self.height * scale))
            new_w = int(round(self.width * scale))
        else:
            max_long, max_short = max(scale), min(scale)
            f = min(max_long / max(self.height, self.width),
                    max_short / min(self.height, self.width))
            hs = ws = f
            new_h, new_w = int(self.height * f + 0.5), int(self.width * f + 0.5)
        return self._scaled(ws, hs, new_h, new_w)

    def resize(self, out_shape, interpolation=None):
        out_h, out_w = out_shape
        return self._scaled(out_w / self.width, out_h / self.height,
                            out_h, out_w)

    def _scaled(self, wx, hy, out_h, out_w):
        out = []
        for poly in self.masks:
            inst = []
            for p in poly:
                q = p.copy()
                q[0::2] *= wx
                q[1::2] *= hy
                inst.append(q)
            out.append(inst)
        return PolygonMasks(out, out_h, out_w)

    def flip(self, flip_direction="horizontal"):
        assert flip_direction in ("horizontal", "vertical", "diagonal")
        out = []
        for poly in self.masks:
            inst = []
            for p in poly:
                q = p.copy()
                if flip_direction in ("horizontal", "diagonal"):
                    q[0::2] = self.width - q[0::2]
                if flip_direction in ("vertical", "diagonal"):
                    q[1::2] = self.height - q[1::2]
                inst.append(q)
            out.append(inst)
        return PolygonMasks(out, self.height, self.width)

    def crop(self, bbox):
        bbox = np.asarray(bbox).copy()
        bbox[0::2] = np.clip(bbox[0::2], 0, self.width)
        bbox[1::2] = np.clip(bbox[1::2], 0, self.height)
        x1, y1, x2, y2 = bbox.astype(int)
        w = max(x2 - x1, 1)
        h = max(y2 - y1, 1)
        out = []
        for poly in self.masks:
            inst = []
            for p in poly:
                q = p.copy()
                q[0::2] = np.clip(q[0::2] - x1, 0, w)
                q[1::2] = np.clip(q[1::2] - y1, 0, h)
                inst.append(q)
            out.append(inst)
        return PolygonMasks(out, h, w)

    def pad(self, out_shape, pad_val=0):
        return PolygonMasks(self.masks, *out_shape)

    def expand(self, *args, **kwargs):
        raise NotImplementedError

    def to_bitmap(self):
        return BitmapMasks(self.to_ndarray(), self.height, self.width)

    @property
    def areas(self):
        """Shoelace area summed over an instance's polygons."""
        area = []
        for poly in self.masks:
            a = 0.0
            for p in poly:
                x, y = p[0::2], p[1::2]
                a += 0.5 * abs(np.dot(x, np.roll(y, 1)) -
                               np.dot(y, np.roll(x, 1)))
            area.append(a)
        return np.asarray(area, np.float32)

    def _rasterize(self, poly_list):
        """Scanline polygon fill (no cv2/pycocotools dependency)."""
        mask = np.zeros((self.height, self.width), np.uint8)
        for p in poly_list:
            xs, ys = p[0::2], p[1::2]
            n = len(xs)
            if n < 3:
                continue
            yy, xx = np.meshgrid(np.arange(self.height) + 0.5,
                                 np.arange(self.width) + 0.5, indexing="ij")
            inside = np.zeros((self.height, self.width), bool)
            j = n - 1
            for i in range(n):
                cond = ((ys[i] > yy) != (ys[j] > yy)) & (
                    xx < (xs[j] - xs[i]) * (yy - ys[i]) /
                    (ys[j] - ys[i] + 1e-12) + xs[i])
                inside ^= cond
                j = i
            mask |= inside.astype(np.uint8)
        return mask

    def to_ndarray(self):
        if len(self.masks) == 0:
            return np.empty((0, self.height, self.width), np.uint8)
        return np.stack([self._rasterize(poly) for poly in self.masks])

    def get_bboxes(self):
        boxes = np.zeros((len(self), 4), np.float32)
        for i, poly in enumerate(self.masks):
            xs = np.concatenate([p[0::2] for p in poly])
            ys = np.concatenate([p[1::2] for p in poly])
            boxes[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
        return boxes

    @classmethod
    def random(cls, num_masks=3, height=32, width=32, n_verts=5, rng=None):
        rng = rng or np.random.RandomState(0)
        masks = []
        for _ in range(num_masks):
            ang = np.sort(rng.rand(n_verts) * 2 * np.pi)
            r = rng.rand(n_verts) * 0.4 + 0.1
            cx, cy = rng.rand(2) * 0.5 + 0.25
            xs = np.clip((cx + r * np.cos(ang)) * width, 0, width)
            ys = np.clip((cy + r * np.sin(ang)) * height, 0, height)
            masks.append([np.stack([xs, ys], -1).reshape(-1)])
        return cls(masks, height, width)
