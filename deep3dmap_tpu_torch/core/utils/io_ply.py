"""Minimal PLY mesh/point-cloud IO (the port's copy of
``deep3dmap_tpu/core/utils/io_ply.py``): binary little-endian writes,
binary or ascii reads."""
from __future__ import annotations

import numpy as np


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray = None):
    verts = np.asarray(verts, np.float32)
    n_f = 0 if faces is None else len(faces)
    with open(path, "wb") as f:
        header = [
            "ply", "format binary_little_endian 1.0",
            f"element vertex {len(verts)}",
            "property float x", "property float y", "property float z",
        ]
        if n_f:
            header += [f"element face {n_f}", "property list uchar int vertex_indices"]
        header.append("end_header")
        f.write(("\n".join(header) + "\n").encode())
        f.write(verts.astype("<f4").tobytes())
        if n_f:
            faces = np.asarray(faces)
            rec = np.empty(n_f, dtype=[("n", "u1"), ("idx", "<i4", 3)])
            rec["n"] = 3
            rec["idx"] = faces
            f.write(rec.tobytes())


def read_ply(path: str):
    """Returns (verts (N,3), faces (F,3) or None). Binary-LE or ascii."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        assert line == b"ply", "not a ply file"
        fmt = None
        n_v = n_f = 0
        props_v = 0
        in_vertex = False
        while True:
            line = f.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1]
            elif line.startswith(b"element vertex"):
                n_v = int(line.split()[-1])
                in_vertex = True
            elif line.startswith(b"element face"):
                n_f = int(line.split()[-1])
                in_vertex = False
            elif line.startswith(b"property") and in_vertex:
                props_v += 1
            elif line == b"end_header":
                break
        if fmt == b"ascii":
            verts = []
            for _ in range(n_v):
                verts.append([float(x) for x in f.readline().split()[:3]])
            faces = []
            for _ in range(n_f):
                parts = f.readline().split()
                faces.append([int(x) for x in parts[1:4]])
            return (np.asarray(verts, np.float32),
                    np.asarray(faces, np.int64) if n_f else None)
        verts_all = np.frombuffer(f.read(n_v * props_v * 4), "<f4").reshape(n_v, props_v)
        verts = verts_all[:, :3].copy()
        faces = None
        if n_f:
            rec = np.frombuffer(f.read(n_f * (1 + 12)),
                                dtype=[("n", "u1"), ("idx", "<i4", 3)])
            faces = rec["idx"].astype(np.int64)
        return verts, faces
