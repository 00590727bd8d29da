"""Host ops in C++: mesh depth rendering and marching tetrahedra (port of
``deep3dmap_tpu/native/__init__.py``).

``ops/csrc/native.cpp`` (a CPython extension over numpy arrays) is built by
``g++`` at its first use into ``ops/_build/`` (listed in ``.gitignore``),
named by a hash of the source and the flags, and loaded from there.  As in
the JAX package, a machine where the build fails gets the numpy versions of
the same functions (``available()`` says which one runs).  These are CPU
loops of the evaluation and the mesh export, not device kernels.  This
module imports neither torch nor CUDA, so the evaluation's worker processes
can use it.
"""
from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig
import tempfile

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_native = None


def _build() -> str:
    py_inc, np_inc = sysconfig.get_path("include"), np.get_include()
    with open(SRC, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(GXX_FLAGS + (py_inc, np_inc))
                             .encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"_native_{key}"
                       + (sysconfig.get_config_var("EXT_SUFFIX") or ".so"))
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, f"-I{py_inc}", f"-I{np_inc}", SRC,
                        "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load():
    global _native
    if _native is None:
        try:
            path = _build()
            loader = importlib.machinery.ExtensionFileLoader("_native", path)
            spec = importlib.util.spec_from_file_location("_native", path, loader=loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            _native = mod
        except (OSError, ImportError, subprocess.CalledProcessError):
            _native = False
    return _native


def available() -> bool:
    """True when the C++ build loaded (else the numpy versions run)."""
    return bool(_load())


def rasterize_mesh(verts, faces, colors, h: int, w: int):
    """Z-buffer rasterization; verts in pixel coords (x, y, z)."""
    mod = _load()
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int64)
    colors = np.ascontiguousarray(colors, np.float32)
    if mod:
        return mod.rasterize_mesh(verts, faces, colors, h, w)
    # numpy version (slow): per-face bounding-box barycentric fill
    C = colors.shape[1]
    img = np.zeros((h, w, C), np.float32)
    dep = np.zeros((h, w), np.float32)
    zbuf = np.full((h, w), np.inf, np.float32)
    for f in faces:
        p = verts[f]
        xmin = max(int(np.floor(p[:, 0].min())), 0)
        xmax = min(int(np.ceil(p[:, 0].max())), w - 1)
        ymin = max(int(np.floor(p[:, 1].min())), 0)
        ymax = min(int(np.ceil(p[:, 1].max())), h - 1)
        if xmin > xmax or ymin > ymax:
            continue
        denom = ((p[1, 0] - p[0, 0]) * (p[2, 1] - p[0, 1])
                 - (p[2, 0] - p[0, 0]) * (p[1, 1] - p[0, 1]))
        if abs(denom) < 1e-12:
            continue
        xs, ys = np.meshgrid(np.arange(xmin, xmax + 1), np.arange(ymin, ymax + 1))
        w1 = ((xs - p[0, 0]) * (p[2, 1] - p[0, 1]) - (p[2, 0] - p[0, 0]) * (ys - p[0, 1])) / denom
        w2 = ((p[1, 0] - p[0, 0]) * (ys - p[0, 1]) - (xs - p[0, 0]) * (p[1, 1] - p[0, 1])) / denom
        w0 = 1 - w1 - w2
        inside = (w0 >= -1e-9) & (w1 >= -1e-9) & (w2 >= -1e-9)
        z = w0 * p[0, 2] + w1 * p[1, 2] + w2 * p[2, 2]
        for yy, xx, zz, a, b, c in zip(ys[inside], xs[inside], z[inside],
                                       w0[inside], w1[inside], w2[inside]):
            if zz < zbuf[yy, xx]:
                zbuf[yy, xx] = zz
                dep[yy, xx] = zz
                img[yy, xx] = a * colors[f[0]] + b * colors[f[1]] + c * colors[f[2]]
    return img, dep


def render_depth(verts, faces, h: int, w: int):
    _, dep = rasterize_mesh(verts, faces,
                            np.zeros((len(verts), 1), np.float32), h, w)
    return dep


def marching_tets(vol, level: float = 0.0):
    mod = _load()
    vol = np.ascontiguousarray(vol, np.float32)
    if mod:
        return mod.marching_tets(vol, float(level))
    from ..core.utils.marching_cubes import marching_tetrahedra

    return marching_tetrahedra(vol, level=level)
