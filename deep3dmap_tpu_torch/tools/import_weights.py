#!/usr/bin/env python
"""Convert torch checkpoints into the ``.npz`` files the port reads (port of
``tools/import_weights.py``, every kind; no JAX needed).  Usage:

    python -m deep3dmap_tpu_torch.tools.import_weights stylegan2 ckpt.pth out.npz \
        [--size 128] [--n-mlp 8] [--channel-multiplier 2] [--style-dim 512]
    python -m deep3dmap_tpu_torch.tools.import_weights vgg16 vgg16.pth out.npz
    python -m deep3dmap_tpu_torch.tools.import_weights bisenet 79999_iter.pth out.npz
    python -m deep3dmap_tpu_torch.tools.import_weights clip ViT-B-16.pt checkpoints/clip_vitb16.npz
    python -m deep3dmap_tpu_torch.tools.import_weights dino dino_vits8.pth checkpoints/dino_vits8.npz
    python -m deep3dmap_tpu_torch.tools.import_weights mnasnet mnasnet1.0.pth \
        checkpoints/mnasnet_fpn.npz [--alpha 1.0] [--device cuda|cpu]

``stylegan2`` takes a rosinality stylegan2-pytorch checkpoint
(``{'g_ema'|'g': ..., 'd': ...}``) and writes ``g`` and ``d``, Gan2Shape's
``gan_ckpt``; ``stylegan2_g``/``stylegan2_d`` write one of them.  ``vgg16``
takes torchvision's VGG16 and writes ``params`` for ``PerceptualLoss``'s
``weights_path``; ``bisenet`` takes the face-parsing BiSeNet and writes
``params`` (its BatchNorms folded) for Gan2Shape's ``parsing_ckpt``.

``mnasnet`` takes torchvision's MNASNet state dict and writes ``params``,
the ``MnasFPN(norm="none", torch_pad=True)`` tree NeuralRecon's
``BACKBONE2D.CKPT`` grafts (its BatchNorms folded, the FPN head from the
port's seeded init); it builds that init on the card unless ``--device
cpu`` is given.  The other kinds are host numpy.

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
    ap.add_argument("kind", choices=["stylegan2", "stylegan2_g", "stylegan2_d", "vgg16",
                                     "mnasnet", "clip", "bisenet", "dino"])
    ap.add_argument("src", help="torch checkpoint path")
    ap.add_argument("dst", help="output .npz path")
    ap.add_argument("--size", type=int, default=128, help="StyleGAN2 resolution")
    ap.add_argument("--n-mlp", type=int, default=8, help="StyleGAN2 mapping depth")
    ap.add_argument("--channel-multiplier", type=int, default=2)
    ap.add_argument("--style-dim", type=int, default=512)
    ap.add_argument("--alpha", type=float, default=1.0,
                    help="MNASNet width multiplier (mnasnet)")
    ap.add_argument("--device", default="cuda",
                    help="mnasnet: cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..utils.torch_import import import_npz_entries

    kw = {}
    if args.kind == "mnasnet":
        from ..utils.device import resolve_device

        kw = dict(alpha=args.alpha, device=resolve_device(args.device))
    raw = torch.load(args.src, map_location="cpu", weights_only=True)
    if args.kind.startswith("stylegan2"):
        kw = dict(size=args.size, n_mlp=args.n_mlp,
                  channel_multiplier=args.channel_multiplier, style_dim=args.style_dim)
    else:
        raw = raw.get("state_dict", raw)
    out = import_npz_entries(args.kind, raw, **kw)
    np.savez(args.dst, **out)
    for k, v in out.items():
        if k != "meta":
            print(f"wrote {k}: {_count(v.item()) / 1e6:.2f}M params")
    return out


if __name__ == "__main__":
    main()
