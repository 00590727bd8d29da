"""Feature detection and matching on the device for the SfM layer (port of
``deep3dmap_tpu/core/sfm/features.py``).

Harris response by two Sobel and three box cross-correlations, non-max
suppression as a max-pool equality test, a fixed number of keypoints by a
stable top-k (static shapes), patch descriptors by one gather, and matching
as one [K, D] x [D, K] product with branch-free mutual-nearest and ratio
filtering.  No host sync.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .triangulate import top_k_indices


def _conv2(img, kernel):
    """Single-channel 2D cross-correlation with SAME padding (zeros, the
    odd remainder after), as ``lax.conv_general_dilated(..., "SAME")``.
    img [H, W], kernel [kh, kw]."""
    kh, kw = kernel.shape
    pt, pl = (kh - 1) // 2, (kw - 1) // 2
    x = F.pad(img[None, None], (pl, kw - 1 - pl, pt, kh - 1 - pt))
    return F.conv2d(x, kernel[None, None])[0, 0]


def _sobel_x(like: torch.Tensor) -> torch.Tensor:
    """[[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]] / 8, made on ``like``'s device
    (a tensor from a Python list would be a host copy, a sync)."""
    r = torch.arange(3, dtype=like.dtype, device=like.device) - 1.0
    return (2.0 - r.abs())[:, None] * r[None, :] / 8.0


def harris_response(img: torch.Tensor, k: float = 0.04, sigma_win: int = 3):
    """Harris corner response for a grayscale image [H, W] in [0, 1]."""
    sobel_x = _sobel_x(img)
    gx = _conv2(img, sobel_x)
    gy = _conv2(img, sobel_x.T)
    box = img.new_ones((sigma_win, sigma_win)) / (sigma_win * sigma_win)
    Sxx, Syy, Sxy = _conv2(gx * gx, box), _conv2(gy * gy, box), _conv2(gx * gy, box)
    det = Sxx * Syy - Sxy * Sxy
    tr = Sxx + Syy
    return det - k * tr * tr


class Keypoints(NamedTuple):
    xy: torch.Tensor      # [K, 2] (x, y) pixel coords
    score: torch.Tensor   # [K]
    valid: torch.Tensor   # [K] bool


def detect_keypoints(img: torch.Tensor, k: int = 512, nms_radius: int = 4,
                     border: int = 8) -> Keypoints:
    """Top-k Harris corners after local non-max suppression (static K)."""
    resp = harris_response(img)
    H, W = resp.shape
    win = 2 * nms_radius + 1
    # max_pool2d pads with -inf, as reduce_window(-inf, max, SAME) does
    pooled = F.max_pool2d(resp[None, None], win, stride=1, padding=nms_radius)[0, 0]
    is_max = resp >= pooled
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    inb = (xx >= border) & (xx < W - border) & (yy >= border) & (yy < H - border)
    score = torch.where(is_max & inb, resp, float("-inf"))
    flat = score.reshape(-1)
    idx = top_k_indices(flat, k)
    top = flat[idx]
    xy = torch.stack([idx % W, idx // W], -1)
    return Keypoints(xy=xy, score=top, valid=torch.isfinite(top) & (top > 0))


def extract_descriptors(img: torch.Tensor, kps: Keypoints, patch: int = 8,
                        stride: int = 2) -> torch.Tensor:
    """Normalized intensity-patch descriptors [K, patch*patch]: a (patch x
    patch) grid with spacing ``stride`` around each keypoint by one clamped
    gather, zero-mean and L2-normalized (matching is then cosine
    similarity)."""
    H, W = img.shape
    half = (patch - 1) * stride / 2.0
    offs = torch.arange(patch, dtype=img.dtype, device=img.device) * stride - half
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    gx = torch.clamp(kps.xy[:, 0:1, None] + ox[None], 0, W - 1)   # [K, p, p]
    gy = torch.clamp(kps.xy[:, 1:2, None] + oy[None], 0, H - 1)
    # non-negative after the clamp: truncation is the floor, as JAX's astype
    vals = img[gy.long(), gx.long()]
    d = vals.reshape(vals.shape[0], -1)
    d = d - torch.mean(d, -1, keepdim=True)
    n = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return d / torch.where(n < 1e-8, 1.0, n)


class Matches(NamedTuple):
    idx1: torch.Tensor    # [K] index into set 1 (identity)
    idx2: torch.Tensor    # [K] best match in set 2
    score: torch.Tensor   # [K] cosine similarity
    valid: torch.Tensor   # [K] bool (mutual + ratio + validity)


def match_descriptors(d1: torch.Tensor, d2: torch.Tensor, valid1=None, valid2=None,
                      ratio: float = 0.9, min_score: float = 0.2) -> Matches:
    """Mutual-nearest descriptor matching with Lowe's ratio test: one
    [K1, D] x [D, K2] product, then elementwise masks.  ``argmax`` takes the
    first of equal values on both sides."""
    sim = d1 @ d2.T
    if valid1 is not None:
        sim = torch.where(valid1[:, None], sim, -2.0)
    if valid2 is not None:
        sim = torch.where(valid2[None, :], sim, -2.0)
    best2 = torch.argmax(sim, dim=1)                    # [K1]
    s12 = torch.amax(sim, dim=1)
    k1 = sim.shape[0]
    rows = torch.arange(k1, device=sim.device)
    # second best for the ratio test: the best column of each row masked out
    cols = torch.arange(sim.shape[1], device=sim.device)
    masked = torch.where(cols[None, :] == best2[:, None], -2.0, sim)
    s2nd = torch.amax(masked, dim=1)
    best1 = torch.argmax(sim, dim=0)                    # [K2]
    mutual = best1[best2] == rows
    # cosine distance ratio: (1 - s12) < ratio * (1 - s2nd)
    ratio_ok = (1.0 - s12) < ratio * (1.0 - s2nd)
    valid = mutual & ratio_ok & (s12 > min_score)
    return Matches(idx1=rows, idx2=best2, score=s12, valid=valid)


def match_images(img1: torch.Tensor, img2: torch.Tensor, k: int = 512, **match_kw):
    """Detect, describe and match two grayscale images; returns
    (kps1, kps2, Matches)."""
    kp1 = detect_keypoints(img1, k=k)
    kp2 = detect_keypoints(img2, k=k)
    d1 = extract_descriptors(img1, kp1)
    d2 = extract_descriptors(img2, kp2)
    m = match_descriptors(d1, d2, kp1.valid, kp2.valid, **match_kw)
    return kp1, kp2, m
