"""The reconstructor and loss registries (port of
``deep3dmap_tpu/models/builder.py``'s ``RECONSTRUCTORS``, ``LOSSES`` and
``build_reconstruction``).  ``NeuralRecon``, ``Gan2Shape``, ``FaceImg2UV``,
``Imgs2Mesh`` and ``GanNerf`` register themselves; ``models/losses/basic.py`` registers
the L1 losses."""
from __future__ import annotations

from ..utils.registry import Registry

RECONSTRUCTORS = Registry("reconstructor")
LOSSES = Registry("loss")


def build_reconstruction(cfg, train_cfg=None, test_cfg=None, device=None):
    """The framework a ``model`` config names, e.g. ``dict(type="NeuralRecon",
    model_cfgs=...)``.  ``device`` (CUDA when None) goes to its constructor;
    a config that names a device keeps it."""
    from .frameworks import (gan2shape, gnerf, imgs2mesh, neuralrecon,  # noqa: F401  (register)
                             prnet)

    cfg = dict(cfg)
    if train_cfg is not None:
        cfg.setdefault("train_cfg", train_cfg)
    if test_cfg is not None:
        cfg.setdefault("test_cfg", test_cfg)
    if device is not None:
        cfg.setdefault("device", device)
    return RECONSTRUCTORS.build(cfg)
