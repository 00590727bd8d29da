#!/usr/bin/env python
"""Convert torch checkpoints into the ``.npz`` files LERF's encoders read
(port of ``tools/import_weights.py``'s ``clip`` and ``dino`` kinds; no JAX
needed).  Usage:

    python -m deep3dmap_tpu_torch.tools.import_weights clip ViT-B-16.pt checkpoints/clip_vitb16.npz
    python -m deep3dmap_tpu_torch.tools.import_weights dino dino_vits8.pth checkpoints/dino_vits8.npz

``clip`` takes an OpenAI or OpenCLIP ViT state dict (a TorchScript archive
unwrapped to its state dict first) and writes ``vision``/``text``/``meta``,
which ``CLIPViT.from_npz`` and a LERF config's ``clip_weights``/``clip_npz``
read; ``dino`` takes a DINO ViT checkpoint and writes ``params``/``meta``
for ``DinoExtractor.from_npz`` and ``dino_npz``.  The files are those of the
JAX tool, key for key.
"""
import argparse

import numpy as np


def _count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    return int(getattr(tree, "size", 0))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kind", choices=["clip", "dino"])
    ap.add_argument("src", help="torch checkpoint path")
    ap.add_argument("dst", help="output .npz path")
    args = ap.parse_args(argv)

    import torch

    from ..utils.torch_import import import_npz_entries

    raw = torch.load(args.src, map_location="cpu", weights_only=True)
    out = import_npz_entries(args.kind, raw.get("state_dict", raw))
    np.savez(args.dst, **out)
    for k, v in out.items():
        if k != "meta":
            print(f"wrote {k}: {_count(v.item()) / 1e6:.2f}M params")
    return out


if __name__ == "__main__":
    main()
