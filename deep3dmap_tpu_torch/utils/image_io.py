"""Image files for the ScanNet data path: one module, independent of OpenCV.

The JAX package reads and writes frames with ``cv2`` (``datasets/scannet.py``,
``datasets/synthetic.py``, ``tools/data_gen/scannet.py``).  The port keeps
``cv2``'s conventions -- colour arrays in BGR order, 16-bit depth as one
``uint16`` channel, the decoder chosen by the file's content, not its name --
with its own PNG codec (``zlib`` and ``struct``): 8-bit grey/RGB/RGBA and
16-bit grey, every PNG row filter, no interlacing.  JPEG goes through ``cv2``
or else ``PIL`` where one is importable; without either, reading a JPEG
raises, naming the file.  Resizing a ``uint8`` frame to another size needs
``cv2`` (its fixed-point ``INTER_LINEAR`` arithmetic is what the JAX
pipeline gives); a resize to the same size is a copy, as it is in ``cv2``.
``resize_float`` resizes float images with ``cv2``'s ``INTER_AREA`` and
``INTER_LINEAR`` weights and no ``cv2`` (Gan2Shape's CelebA reader);
``resize_uint8_area`` rounds them as ``cv2`` does on a ``uint8`` frame
(GNeRF's DTU reader).

The encoder writes filter type 0 (none) on every row, so the fixture frames
the port writes decode without a loop over rows.  Rows that another encoder
wrote with the Average or Paeth filter are undone in a Python loop: correct,
but slow on large frames.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_JPEG_MAGIC = b"\xff\xd8\xff"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of a (H, W) or (H, W, 3|4) ``uint8`` array in BGR(A) order,
    or a (H, W) ``uint16`` array, as ``cv2.imwrite`` stores them."""
    a = np.asarray(img)
    if a.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"encode_png: uint8 or uint16 wanted, got {a.dtype}")
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[..., 0]
    if a.ndim == 2:
        ctype = 0
    elif a.ndim == 3 and a.shape[2] in (3, 4) and a.dtype == np.uint8:
        ctype = 2 if a.shape[2] == 3 else 6
        a = np.concatenate([a[..., 2::-1], a[..., 3:]], axis=2)   # BGR(A) -> RGB(A)
    else:
        raise ValueError(f"encode_png: unsupported shape {a.shape} for {a.dtype}")
    h, w = a.shape[:2]
    depth = 8 * a.dtype.itemsize
    rows = np.ascontiguousarray(a.astype(a.dtype.newbyteorder(">"))).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows.reshape(h, -1)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (_PNG_MAGIC + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def _unfilter_slow(ftype: int, cur: bytearray, prev: bytes, bpp: int) -> None:
    for x in range(len(cur)):
        a = cur[x - bpp] if x >= bpp else 0
        b = prev[x]
        if ftype == 3:
            cur[x] = (cur[x] + ((a + b) >> 1)) & 0xFF
        else:
            c = prev[x - bpp] if x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[x] = (cur[x] + pred) & 0xFF


def decode_png(data: bytes) -> np.ndarray:
    """The array ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` gives for PNG
    bytes: (H, W) grey, (H, W, 3|4) BGR(A); ``uint16`` at bit depth 16."""
    if not data.startswith(_PNG_MAGIC):
        raise ValueError("decode_png: not a PNG stream")
    pos, idat, hdr = len(_PNG_MAGIC), [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("decode_png: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth not in (8, 16) or ctype not in _CHANNELS or interlace:
        raise ValueError(f"decode_png: bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace} are not supported")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    filtered = bool(raw[:, 0].any())
    if not filtered:                        # every row unfiltered (encode_png's)
        out[:] = raw[:, 1:]
    for y in range(h if filtered else 0):
        ftype, row = int(raw[y, 0]), raw[y, 1:]
        if ftype == 0:
            cur = row.copy()
        elif ftype == 1:     # Sub: a running sum per byte of the pixel, mod 256
            cur = (np.cumsum(row.reshape(w, bpp).astype(np.int64), axis=0)
                   .astype(np.uint8).reshape(-1))
        elif ftype == 2:
            cur = row + prev
        elif ftype in (3, 4):
            buf = bytearray(row.tobytes())
            _unfilter_slow(ftype, buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"decode_png: row filter {ftype}")
        out[y] = cur
        prev = cur
    if depth == 16:
        img = out.view(">u2").astype(np.uint16).reshape(h, w, ch)
    else:
        img = out.reshape(h, w, ch)
    if ch == 1:
        return img[..., 0]
    if ch >= 3:
        img = np.concatenate([img[..., 2::-1], img[..., 3:]], axis=2)  # -> BGR(A)
    return np.ascontiguousarray(img)


def _decode_jpeg(data: bytes, path: str) -> np.ndarray:
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f"{path}: cv2 could not decode this JPEG")
        return img
    try:
        import io

        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{path} is a JPEG and neither cv2 nor PIL is importable to decode "
            f"it; write the frames as PNG (datasets/synthetic.py's "
            f"write_scannet_fixture does)") from None
    with Image.open(io.BytesIO(data)) as im:
        return np.ascontiguousarray(np.asarray(im.convert("RGB"))[..., ::-1])


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` for PNG, ``cv2.imread(path)``
    for JPEG; the format comes from the file's first bytes."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_PNG_MAGIC):
        return decode_png(data)
    if data.startswith(_JPEG_MAGIC):
        return _decode_jpeg(data, path)
    raise ValueError(f"{path}: neither PNG nor JPEG")


def imwrite_png(path: str, img: np.ndarray) -> None:
    """Write ``img`` as PNG, whatever the file's extension."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def resize(img: np.ndarray, size, nearest: bool = False) -> np.ndarray:
    """``cv2.resize(img, size)`` with ``size = (W, H)``, bilinear
    (``INTER_LINEAR``) or ``nearest`` (``INTER_NEAREST``)."""
    img = np.asarray(img)
    if tuple(size) == (img.shape[1], img.shape[0]):
        return img.copy()
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            f"resizing {img.shape[1]}x{img.shape[0]} to {size[0]}x{size[1]} "
            f"needs cv2; store frames at the pipeline's size") from None
    return cv2.resize(img, tuple(size),
                      interpolation=cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR)


def _linear_weights(n_in: int, n_out: int, area_mode: bool = False) -> np.ndarray:
    """(n_out, n_in) weights of ``cv2.resize``'s ``INTER_LINEAR`` on one axis
    (and of ``INTER_AREA`` when it enlarges, ``area_mode``): two taps at
    ``floor`` of the source position, clamped at the borders."""
    scale = n_in / n_out
    w = np.zeros((n_out, n_in), np.float32)
    for d in range(n_out):
        if area_mode:
            sx = int(np.floor(d * scale))
            fx = (d + 1) - (sx + 1) / scale
            fx = 0.0 if fx <= 0 else fx - np.floor(fx)
        else:
            fx = (d + 0.5) * scale - 0.5
            sx = int(np.floor(fx))
            fx -= sx
        if sx < 0:
            fx, sx = 0.0, 0
        if sx >= n_in - 1:
            fx, sx = 0.0, n_in - 1
        fx = np.float32(fx)
        w[d, sx] += 1 - fx
        w[d, min(sx + 1, n_in - 1)] += fx
    return w


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of ``cv2.resize``'s ``INTER_AREA`` when it
    shrinks: each output sample averages the source cells it covers, a
    partly covered cell by the share it covers (a box mean at an integer
    factor)."""
    scale = n_in / n_out
    w = np.zeros((n_out, n_in), np.float64)
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s1 = min(int(np.ceil(f1)), n_in - 1)
        s2 = min(int(np.floor(f2)), n_in - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] = (s1 - f1) / cell
        w[d, s1:s2] = 1.0 / cell
        if f2 - s2 > 1e-3:
            w[d, s2] = min(min(f2 - s2, 1.0), cell) / cell
    return w.astype(np.float32)


def resize_float(img: np.ndarray, size, area: bool = True) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=INTER_AREA)`` (or ``INTER_LINEAR``
    with ``area=False``) of a float32 (H, W[, C]) image, ``size = (W, H)``:
    one weight matrix per axis, rows then columns, in float32."""
    img = np.asarray(img, np.float32)
    w_out, h_out = size
    h, w = img.shape[:2]
    if (w_out, h_out) == (w, h):
        return img.copy()

    def weights(n_in, n_out):
        if area and n_out < n_in:
            return _area_weights(n_in, n_out)
        return _linear_weights(n_in, n_out, area_mode=area)
    out = np.tensordot(weights(w, w_out), img, axes=([1], [1]))    # (W', H[, C])
    out = np.tensordot(weights(h, h_out), out, axes=([1], [1]))    # (H', W'[, C])
    return np.ascontiguousarray(out, np.float32)


def resize_uint8_area(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=INTER_AREA)`` of a ``uint8``
    (H, W[, C]) frame, ``size = (W, H)``, as float32 levels: the area means
    of ``resize_float``, rounded as ``cv2`` rounds them.  A 2x shrink on both
    axes takes ``cv2``'s (sum + 2) >> 2 (half up), other integer factors its
    ``cvRound`` (half to even), both exact; at a ratio that is not an
    integer ``cv2`` accumulates its weights in another order, and a level
    can differ by one where a mean sits at a half."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    out = resize_float(img.astype(np.float32), size, area=True)
    if (w, h) == tuple(size):
        return out
    if (w, h) == (2 * size[0], 2 * size[1]):
        return np.floor(out + 0.5)
    return np.rint(out)
