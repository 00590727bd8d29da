#!/usr/bin/env python
"""MultiPIE data preparation: landmark detection and the index packaging
(the port's twin of ``tools/data_gen/multipie.py``).  Usage:

    python -m deep3dmap_tpu_torch.tools.data_gen_multipie organize --labels L.txt --out D \\
        [--uvtex-list U.txt] [--obj-list O.txt --obj-root R --model-shape Model_Shape.mat]
    python -m deep3dmap_tpu_torch.tools.data_gen_multipie get-lmk --list I.txt --out D

``organize`` turns a label file (``imgpath id poseidx`` per line) into the
pickled indexes the MultiPIE datasets read:
``multipie_idillumexp2poseimgpaths.pkl`` (id -> illumination ->
expression -> camera -> image paths) and, with ``--uvtex-list``,
``multipie_uvtex2poseimgs.pkl`` (each UV texture's frontal-illumination
images).  Host numpy and pickle: no card.

The FAN steps -- ``get-lmk``, and ``organize``'s aux-info step that
``--obj-list`` with ``--model-shape`` turns on -- fail as the JAX tool's do,
at the same call: the tool builds ``FaceAlignment(weights_path=...)``,
which takes no ``weights_path``, and would then call
``get_landmarks_from_image`` without the face boxes it needs.  The port
raises ``TypeError`` there and says so; it adds no detector and no box
rule.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle

import numpy as np

# MultiPIE camera labels indexed by the label file's pose id
POSE2CAM = ["11_0", "12_0", "09_0", "08_0", "13_0", "14_0", "05_1", "05_0",
            "04_1", "19_0", "20_0", "01_0", "24_0"]

# session -> recordid -> expression
_EXPR = {
    "01": {"01": "neutral", "02": "smile"},
    "02": {"01": "neutral", "02": "surprise", "03": "squint"},
    "03": {"01": "neutral", "02": "smile", "03": "disgust"},
    "04": {"01": "neutral", "02": "neutral", "03": "scream"},
}


def get_expression(session: str, recordid: str) -> str:
    return _EXPR.get(session, {}).get(recordid, "neutral")


def _face_alignment(fan_weights):
    """The FAN the JAX tool builds, at the call where it fails."""
    from ..models.face_alignment import FaceAlignment

    try:
        return FaceAlignment(weights_path=fan_weights)
    except TypeError as e:
        raise TypeError(
            "data_gen_multipie: the FAN step cannot run, as in the JAX tool "
            "(tools/data_gen/multipie.py): FaceAlignment takes no weights_path "
            "(its weights come as params=), and get_landmarks_from_image needs "
            f"face boxes this tool has none of ({e})") from e


def cmd_get_lmk(args):
    """FAN landmarks for every image of the list, one ``<name>_lm68.npy``
    each; fails at the FAN's construction (see the module's docstring)."""
    _face_alignment(args.fan_weights)


def read_obj(objpath: str) -> np.ndarray:
    """Vertex positions of a ``.obj``."""
    verts = []
    with open(objpath) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
    return np.asarray(verts, np.float64)


def cmd_organize(args):
    """Write the pickled indexes; the aux-info step fails at the FAN's
    construction (see the module's docstring)."""
    os.makedirs(args.out, exist_ok=True)

    # 1. id/illum/expression -> pose -> image paths
    index = {}
    with open(args.labels) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) < 3:
                continue
            imgpath, idx, poseidx = parts[0], int(parts[1]), int(parts[2])
            fields = osp.basename(imgpath).split("_")
            session, recordid = fields[1], fields[2]
            illum = fields[-1].split(".")[0]
            index.setdefault(idx, {}).setdefault(illum, {}).setdefault(
                get_expression(session, recordid), {}).setdefault(
                POSE2CAM[poseidx], []).append(imgpath)
    with open(osp.join(args.out, "multipie_idillumexp2poseimgpaths.pkl"), "wb") as f:
        pickle.dump(index, f)
    print("ids:", len(index))

    # 2. uvtex -> pose images (the frontal-illumination "10" bucket)
    if args.uvtex_list:
        uvtex2poseimgs = {}
        with open(args.uvtex_list) as f:
            for line in f:
                filename = line.strip()
                if not filename:
                    continue
                base = osp.basename(filename)
                idx = int(base.split("_")[0]) - 1
                session = base.split("_")[1]
                recordid = base.split("_")[2].split(".")[0]
                bucket = index.get(idx, {}).get("10", {}).get(
                    get_expression(session, recordid))
                if bucket:
                    uvtex2poseimgs[filename] = bucket
        with open(osp.join(args.out, "multipie_uvtex2poseimgs.pkl"), "wb") as f:
            pickle.dump(uvtex2poseimgs, f)
        print("uvtex:", len(uvtex2poseimgs))

    # 3. per-image aux info from FAN landmarks
    if args.obj_list and args.model_shape:
        _face_alignment(args.fan_weights)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("get-lmk")
    p1.add_argument("--list", required=True, help="txt of image paths")
    p1.add_argument("--root", default="", help="image root dir")
    p1.add_argument("--out", required=True)
    p1.add_argument("--fan-weights", default=None)
    p1.set_defaults(fn=cmd_get_lmk)
    p2 = sub.add_parser("organize")
    p2.add_argument("--labels", required=True, help="label txt: imgpath id poseidx per line")
    p2.add_argument("--root", default="")
    p2.add_argument("--out", required=True)
    p2.add_argument("--uvtex-list", default=None)
    p2.add_argument("--obj-list", default=None)
    p2.add_argument("--obj-root", default="")
    p2.add_argument("--model-shape", default=None, help="Model_Shape.mat with 'keypoints'")
    p2.add_argument("--fan-weights", default=None)
    p2.set_defaults(fn=cmd_organize)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
