"""Gan2Shape's parsing models (port of ``deep3dmap_tpu/models/parsing``):
the face-parsing BiSeNet that the published checkpoint imports into
(``BiSeNetFP``, ``FaceParser``), the PSPNet scene parser (``PSPNet``,
``SceneParser``) and the compact ``BiSeNet``."""
from .bisenet import BiSeNet
from .bisenet_fp import BiSeNetFP, FaceParser
from .pspnet import PSPNet, SceneParser

__all__ = ["BiSeNet", "BiSeNetFP", "FaceParser", "PSPNet", "SceneParser"]
