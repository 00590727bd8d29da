"""The model registries (port of ``deep3dmap_tpu/models/builder.py``):
``MODELS`` and its children ``BACKBONES``, ``LOSSES`` and
``RECONSTRUCTORS``, with ``build_backbone``, ``build_loss`` and
``build_reconstruction``.  ``NeuralRecon``, ``Gan2Shape``, ``FaceImg2UV``,
``Imgs2Mesh``, ``GanNerf`` and ``LERFModel`` register themselves;
``models/losses/basic.py`` registers the L1 losses; every backbone (and the
parsers and GNeRF's inversion net, as in JAX) registers under JAX's
names."""
from __future__ import annotations

from ..utils.registry import Registry

MODELS = Registry("models")
BACKBONES = Registry("backbone", parent=MODELS)
LOSSES = Registry("loss", parent=MODELS)
RECONSTRUCTORS = Registry("reconstructor", parent=MODELS)


def _register_backbones() -> None:
    from . import backbones  # noqa: F401  (register)
    from .modulars import inversion_net  # noqa: F401
    from .parsing import bisenet, bisenet_fp, pspnet  # noqa: F401


def build_backbone(cfg, **default_args):
    """The backbone a config names, e.g. ``dict(type="ResNetV1",
    layers=(2, 2))``."""
    _register_backbones()
    return BACKBONES.build(dict(cfg), **default_args)


def build_loss(cfg, **default_args):
    from .losses import basic  # noqa: F401  (register)
    return LOSSES.build(dict(cfg), **default_args)


def build_reconstruction(cfg, train_cfg=None, test_cfg=None, device=None):
    """The framework a ``model`` config names, e.g. ``dict(type="NeuralRecon",
    model_cfgs=...)``.  ``device`` (CUDA when None) goes to its constructor;
    a config that names a device keeps it."""
    from .frameworks import (gan2shape, gnerf, imgs2mesh, lerf,  # noqa: F401  (register)
                             neuralrecon, prnet)

    cfg = dict(cfg)
    if train_cfg is not None:
        cfg.setdefault("train_cfg", train_cfg)
    if test_cfg is not None:
        cfg.setdefault("test_cfg", test_cfg)
    if device is not None:
        cfg.setdefault("device", device)
    return RECONSTRUCTORS.build(cfg)
