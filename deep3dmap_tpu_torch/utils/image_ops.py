"""The OpenCV image operations of the detection pipelines, in numpy and
without OpenCV.

The JAX package's single-image pipelines call ``cv2.resize``,
``cv2.warpAffine``, ``cv2.cvtColor`` (RGB <-> HSV on ``uint8``),
``cv2.getAffineTransform`` and ``cv2.getRotationMatrix2D``.  These copies
give what OpenCV 5.0's x86-64 build gives, bit for bit (held against
``cv2`` by ``tests/test_torch_image_ops.py``):

- ``resize`` (``INTER_NEAREST``: the source index ``floor(d * in / out)``;
  ``INTER_LINEAR``): on ``uint8`` the fixed-point path of
  ``resize.cpp`` -- 11-bit weights rounded from float32 positions, the
  horizontal pass ``S0*a0 + S1*a1`` in int32 (``HResizeLinear``), and the
  vertical pass of ``VResizeLinearVec_32s8u``: ``(((S0>>4)*b0)>>16) +
  (((S1>>4)*b1)>>16) + 2) >> 2``.  Columns past the last source pixel take
  it alone; rows past an edge repeat the edge row with the row weights
  unchanged (an exact 2x shrink, which OpenCV hands to ``INTER_AREA``,
  gives the same numbers).  On ``float32`` the fractions are float32
  roundings of double positions ``(d + 0.5) * in / out - 0.5`` (a fraction
  that rounds to 1 keeps its taps) and each pass is one fused multiply-add,
  ``S0 + f*(S1 - S0)``, except in the columns before the first and past the
  last source pixel: there the vertical lerp rounds its product and its sum
  apart on 16-pixel blocks with 4 channels, and on the first two channels
  of a remainder of 5 or more pixels with 3 or 4 (``_unfused_columns``).
  A source of one row or one column takes OpenCV's generic path instead:
  float32 positions, and ``S0*(1-f) + S1*f`` without fused multiply-adds.
- ``warp_affine`` (``INTER_LINEAR``/``INTER_NEAREST``, constant border):
  the inverse map in float32, source x as ``fma(M0, x, float(y*M1) + M2)``
  on 16-pixel vector blocks and ``fma(x, M0, y*M1) + M2`` on a row's tail;
  nearest takes the tap at the rounded position (half to even), bilinear
  two fused lerps along x and one along y, taps outside the image reading
  the border value; ``uint8`` rounds half to even.
- ``rgb_to_hsv``/``hsv_to_rgb`` (``uint8``, H in [0, 180)): the 12-bit
  division tables of ``color_hsv``, and for the way back float32 sectors
  with fused ``1 - s*h`` terms, truncated on 32-pixel vector blocks and
  rounded on a row's tail.

A fused multiply-add is emulated in float64 and rounded once to float32
(exact but for double rounding, which no test input meets).

The vector layout is build-dependent.  It was taken from OpenCV 5.0.0's
x86-64 wheel (baseline SSE3, dispatched up to AVX2 and AVX512_SKX) on a
Xeon with AVX-512, and it is the layout of that build's AVX2 dispatch: the
tests stay bit-equal with AVX-512 switched off (``OPENCV_CPU_DISABLE=
AVX512F,AVX512-SKX``) and fail with AVX2 switched off as well, where
``warpAffine`` differs by up to 0.018 on ``float32`` and by 1 on up to
0.05% of ``uint8`` values, and HSV -> RGB by 1 on up to 1.4% (``ROADMAP.md``
Queue 3).  The parts that belong to the build are ``_WARP_BLOCK``,
``_HSV_BLOCK``, the resize's edge rule (``_RESIZE_EDGE_BLOCK``,
``_RESIZE_EDGE_MIN``) and the scalar order on each row's tail; a ``cv2`` that
dispatches otherwise (SSE4 only, NEON, another version) is another
target.
"""
from __future__ import annotations

import math

import numpy as np

_F32 = np.float32
_COEF_SCALE = 2048                 # INTER_RESIZE_COEF_SCALE (11 bits)
_HSV_SHIFT = 12
_WARP_BLOCK = 16                   # pixels per vector step of warpAffine
_HSV_BLOCK = 32                    # pixels per vector step of HSV -> RGB
_RESIZE_EDGE_BLOCK = 16            # edge-column pixels per vector step of a float32 resize
_RESIZE_EDGE_MIN = 5               # the shortest edge remainder OpenCV vectorises
# (b, g, r) picks from (v, v(1-s), v(1-s h), v(1-s(1-h))) per hue sector
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a*b + c`` rounded once (float32 products are exact in
    float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def _as_hwc(img: np.ndarray) -> np.ndarray:
    return img.reshape(img.shape[0], img.shape[1], -1)


def _like_cv2(out: np.ndarray, img: np.ndarray) -> np.ndarray:
    """(H, W, C) -> the layout OpenCV returns: one channel as (H, W)."""
    return out[..., 0] if out.shape[2] == 1 else out.reshape(out.shape[:2] + img.shape[2:])


# ------------------------------------------------------------------ resize --
def _taps(n_in: int, n_out: int):
    """Source index and float64 fraction of each output sample along one
    axis: ``(d + 0.5) * scale - 0.5`` as ``resize.cpp`` computes it."""
    scale = 1.0 / (n_out / n_in)
    pos = (np.arange(n_out) + 0.5) * scale - 0.5
    return pos, np.floor(pos).astype(np.int64)


def _u8_weights(n_in: int, n_out: int, clamp: bool):
    pos, _ = _taps(n_in, n_out)
    f = pos.astype(_F32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(_F32)).astype(_F32)
    past = np.zeros(n_out, bool)
    if clamp:                      # the x axis: indices and weights clamped
        f[s < 0] = 0
        s[s < 0] = 0
        past = s >= n_in - 1
        f[past] = 0
        s[past] = n_in - 1
    w0 = np.rint((_F32(1) - f) * _F32(_COEF_SCALE)).astype(np.int32)
    w1 = np.rint(f * _F32(_COEF_SCALE)).astype(np.int32)
    return s, w0, w1, past


def _resize_u8(src: np.ndarray, W: int, H: int) -> np.ndarray:
    h, w = src.shape[:2]
    s = src.astype(np.int32)             # every product below fits in int32
    sx, a0, a1, past = _u8_weights(w, W, clamp=True)
    rows = s[:, sx] * a0[None, :, None] + s[:, np.minimum(sx + 1, w - 1)] * a1[None, :, None]
    rows[:, past] = s[:, sx[past]] * _COEF_SCALE
    sy, b0, b1, _ = _u8_weights(h, H, clamp=False)
    r0 = rows[np.clip(sy, 0, h - 1)] >> 4
    r1 = rows[np.clip(sy + 1, 0, h - 1)] >> 4
    out = (((r0 * b0[:, None, None]) >> 16) + ((r1 * b1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _float_weights(n_in: int, n_out: int, clamp: bool):
    """Source index and float32 fraction of each output sample for the
    ``float32`` path: the position ``(d + 0.5) * (in / out) - 0.5`` in
    double, its floor, and the fraction rounded to float32 (it may round to
    1).  On the x axis the columns before the first and past the last source
    pixel take that pixel alone; ``left``/``right`` mark them."""
    pos = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    s = np.floor(pos).astype(np.int64)
    f = (pos - s).astype(_F32)
    left = right = np.zeros(n_out, bool)
    if clamp:
        left, right = s < 0, s >= n_in - 1
        f[left | right] = 0
        s = np.clip(s, 0, n_in - 1)
    return s, f, left, right


def _unfused_columns(edge: np.ndarray, c: int) -> np.ndarray:
    """(W, c) mask of the values whose vertical lerp OpenCV rounds twice
    (``r0 + round(f * (r1 - r0))``) in one run of edge columns: with 4
    channels the full blocks of ``_RESIZE_EDGE_BLOCK`` pixels, and with 3 or
    4 the first ``2 * (c // 2)`` channels of a remainder of at least
    ``_RESIZE_EDGE_MIN`` pixels.  Every other value is one fused
    multiply-add."""
    idx = np.nonzero(edge)[0]
    k = len(idx) // _RESIZE_EDGE_BLOCK * _RESIZE_EDGE_BLOCK
    m = np.zeros((len(edge), c), bool)
    if c == 4:
        m[idx[:k]] = True
    if len(idx) - k >= _RESIZE_EDGE_MIN:
        m[idx[k:], :2 * (c // 2)] = True
    return m


def _resize_f32_thin(src: np.ndarray, W: int, H: int) -> np.ndarray:
    """A source of one row or one column: OpenCV's generic path, with
    float32 positions and each pass two products and a sum, no fused
    multiply-add."""
    h, w = src.shape[:2]

    def weights(n_in, n_out, clamp):
        p = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(_F32)
        s = np.floor(p).astype(np.int64)
        f = (p - s.astype(_F32)).astype(_F32)
        if clamp:
            out = (s < 0) | (s >= n_in - 1)
            f[out] = 0
            s = np.clip(s, 0, n_in - 1)
        return s, _F32(1) - f, f

    sx, a0, a1 = weights(w, W, True)
    rows = (src[:, sx] * a0[None, :, None]
            + src[:, np.minimum(sx + 1, w - 1)] * a1[None, :, None])
    sy, b0, b1 = weights(h, H, False)
    return (rows[np.clip(sy, 0, h - 1)] * b0[:, None, None]
            + rows[np.clip(sy + 1, 0, h - 1)] * b1[:, None, None])


def _resize_f32(src: np.ndarray, W: int, H: int) -> np.ndarray:
    h, w, c = src.shape
    if h == 1 or w == 1:
        return _resize_f32_thin(src, W, H)
    sx, fx, left, right = _float_weights(w, W, clamp=True)
    s0, s1 = src[:, sx], src[:, np.minimum(sx + 1, w - 1)]
    rows = _fma(fx[None, :, None], s1 - s0, s0)
    sy, fy, _, _ = _float_weights(h, H, clamp=False)
    r0, r1 = rows[np.clip(sy, 0, h - 1)], rows[np.clip(sy + 1, 0, h - 1)]
    fy = fy[:, None, None]
    out = _fma(fy, r1 - r0, r0)
    unfused = _unfused_columns(left, c) | _unfused_columns(right, c)
    if unfused.any():
        out = np.where(unfused[None], r0 + (fy * (r1 - r0)).astype(_F32), out)
    return out


def _resize_nearest(img: np.ndarray, W: int, H: int) -> np.ndarray:
    """``INTER_NEAREST``: source index ``floor(d * in / out)``, clamped."""
    h, w = img.shape[:2]
    sx = np.minimum(np.floor(np.arange(W) * (1.0 / (W / w))).astype(np.int64), w - 1)
    sy = np.minimum(np.floor(np.arange(H) * (1.0 / (H / h))).astype(np.int64), h - 1)
    return img[sy][:, sx]


def resize(img: np.ndarray, size, nearest: bool = False) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)`` (or
    ``INTER_NEAREST``, any dtype), ``size = (W, H)``, of a ``uint8`` or
    ``float32`` (H, W[, C]) image."""
    img = np.asarray(img)
    W, H = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if W <= 0 or H <= 0:
        raise ValueError(f"resize: size {size} is empty")
    if (W, H) == (w, h):
        return img.copy()
    if nearest:
        return _like_cv2(_as_hwc(_resize_nearest(img, W, H)), img)
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f"resize: uint8 or float32 wanted, got {img.dtype}")
    src = _as_hwc(img)
    out = _resize_u8(src, W, H) if img.dtype == np.uint8 else _resize_f32(src, W, H)
    return _like_cv2(out, img)


# ------------------------------------------------------------ warp_affine --
def _invert_affine(M) -> np.ndarray:
    """The inverse of a 2x3 affine map, as ``warpAffine`` forms it (float64,
    flattened)."""
    m = np.asarray(M, np.float64).reshape(6).copy()
    det = m[0] * m[4] - m[1] * m[3]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[4] * det, m[0] * det
    m[0], m[1], m[3], m[4] = a11, -m[1] * det, -m[3] * det, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def _source_coords(M, W: int, H: int):
    """float32 source coordinates of every destination pixel."""
    m = _invert_affine(M).astype(_F32)
    x = np.arange(W, dtype=_F32)[None, :]
    y = np.arange(H, dtype=_F32)[:, None]
    bx = (y * m[1]).astype(_F32) + m[2]
    by = (y * m[4]).astype(_F32) + m[5]
    sx, sy = _fma(m[0], x, bx), _fma(m[3], x, by)
    t = (W // _WARP_BLOCK) * _WARP_BLOCK           # the row's scalar tail
    if t < W:
        xt = x[:, t:]
        sx[:, t:] = _fma(xt, m[0], (y * m[1]).astype(_F32)) + m[2]
        sy[:, t:] = _fma(xt, m[3], (y * m[4]).astype(_F32)) + m[5]
    return sx, sy


def warp_affine(img: np.ndarray, M, size, nearest: bool = False,
                border_value=0) -> np.ndarray:
    """``cv2.warpAffine(img, M, size, flags=INTER_LINEAR or INTER_NEAREST,
    borderValue=border_value)`` with ``size = (W, H)`` and a constant
    border (a Scalar: missing channels take 0), for ``uint8`` and
    ``float32`` images with 1, 3 or 4 channels."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f"warp_affine: uint8 or float32 wanted, got {img.dtype}")
    W, H = int(size[0]), int(size[1])
    src = _as_hwc(img).astype(_F32)
    h, w, cn = src.shape
    # a Scalar: up to four values, the missing ones 0
    bv = np.zeros(4)
    given = np.asarray(border_value, np.float64).reshape(-1)[:4]
    bv[:len(given)] = given
    bv = bv[:cn]
    if img.dtype == np.uint8:
        bv = np.clip(np.rint(bv), 0, 255)
    bv = bv.astype(_F32)
    sx, sy = _source_coords(M, W, H)

    def tap(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(inside[..., None], v, bv)

    if nearest:
        out = tap(np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64))
    else:
        x0, y0 = np.floor(sx), np.floor(sy)
        ax = (sx - x0).astype(_F32)[..., None]
        ay = (sy - y0).astype(_F32)[..., None]
        x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
        v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
        v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
        top = _fma(ax, v01 - v00, v00)
        bottom = _fma(ax, v11 - v10, v10)
        out = _fma(ay, bottom - top, top)
    if img.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return _like_cv2(out, img)


def get_rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the centre goes through float32, the
    matrix is float64, angles in degrees, counter-clockwise."""
    cx, cy = (float(_F32(c)) for c in center)
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def get_affine_transform(src, dst) -> np.ndarray:
    """``cv2.getAffineTransform``: the 2x3 map taking three points to three
    points (float64)."""
    s = np.asarray(src, np.float64).reshape(3, 2)
    d = np.asarray(dst, np.float64).reshape(3, 2)
    a = np.zeros((6, 6))
    a[0::2, 0:2], a[0::2, 2] = s, 1
    a[1::2, 3:5], a[1::2, 5] = s, 1
    return np.linalg.solve(a, d.reshape(6)).reshape(2, 3)


# --------------------------------------------------------------------- HSV --
def _hsv_tables():
    i = np.maximum(np.arange(256, dtype=np.float64), 1)
    sdiv = np.rint((255 << _HSV_SHIFT) / i).astype(np.int32)
    hdiv = np.rint((180 << _HSV_SHIFT) / (6.0 * i)).astype(np.int32)
    sdiv[0] = hdiv[0] = 0
    return sdiv, hdiv


_SDIV, _HDIV = _hsv_tables()


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` of a ``uint8`` (..., 3)
    image: H in [0, 180), S and V in [0, 255]."""
    a = np.asarray(img)
    if a.dtype != np.uint8 or a.shape[-1] != 3:
        raise TypeError(f"rgb_to_hsv: uint8 (..., 3) wanted, got {a.dtype} {a.shape}")
    a = a.astype(np.int32)               # the products fit in int32
    r, g, b = a[..., 0], a[..., 1], a[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2RGB)`` of a ``uint8`` (..., 3) image
    with H in [0, 180)."""
    a = np.asarray(img)
    if a.dtype != np.uint8 or a.shape[-1] != 3:
        raise TypeError(f"hsv_to_rgb: uint8 (..., 3) wanted, got {a.dtype} {a.shape}")
    a = a.astype(_F32)
    inv = _F32(1.0 / 255.0)
    s = (a[..., 1] * inv).astype(_F32)
    v = (a[..., 2] * inv).astype(_F32)
    hh = (a[..., 0] * _F32(6.0 / 180.0)).astype(_F32)
    sector = np.floor(hh)
    frac = (hh - sector).astype(_F32)
    sector = sector.astype(np.int64) % 6
    one = _F32(1)
    tab = np.stack([v, (v * (one - s)).astype(_F32),
                    (v * _fma(-s, frac, one)).astype(_F32),
                    (v * _fma(-s, (one - frac).astype(_F32), one)).astype(_F32)], -1)
    bgr = np.take_along_axis(tab, _HSV_SECTORS[sector], -1)
    rgb = (bgr[..., ::-1] * _F32(255)).astype(_F32)
    # vector blocks of a row truncate; the row's scalar tail rounds
    w = rgb.shape[-2]
    tail = np.arange(w) >= (w // _HSV_BLOCK) * _HSV_BLOCK
    out = np.where(tail[:, None], np.rint(rgb), np.floor(rgb))
    return np.clip(out, 0, 255).astype(np.uint8)
