"""The port's frameworks (the names of
``deep3dmap_tpu/models/frameworks/__init__.py``), exported lazily."""
from ..._lazy import export

_MODULES = {
    "base": ("BaseFramework", "parse_losses"),
    "neuralrecon": ("NeuralRecon",),
    "prnet": ("FaceImg2UV",),
    "imgs2mesh": ("Imgs2Mesh",),
    "gnerf": ("GanNerf",),
    "gan2shape": ("Gan2Shape",),
    "lerf": ("LERFModel",),
}
__all__, __getattr__, __dir__ = export(__name__, _MODULES)
