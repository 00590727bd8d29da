"""The port's models (the names of ``deep3dmap_tpu/models/__init__.py``),
exported lazily.  The registries come filled with every name the JAX
package registers: the backbones, the parsers, GNeRF's inversion net, the
losses and the frameworks."""
from .._lazy import export

_MODULES = {
    "builder": ("MODELS", "BACKBONES", "LOSSES", "RECONSTRUCTORS", "build_backbone",
                "build_loss", "build_reconstruction"),
}
_REGISTERING = ("backbones", "modulars.inversion_net", "parsing", "losses.basic",
                "losses.perceptual_loss", "frameworks.neuralrecon", "frameworks.prnet",
                "frameworks.imgs2mesh", "frameworks.gnerf", "frameworks.gan2shape",
                "frameworks.lerf")

__all__, __getattr__, __dir__ = export(
    __name__, _MODULES, ("MODELS", "BACKBONES", "LOSSES", "RECONSTRUCTORS"), _REGISTERING)
