"""The port's losses (the names of ``deep3dmap_tpu/models/losses/__init__.py``),
exported lazily."""
from ..._lazy import export

_MODULES = {
    "basic": ("L1Loss", "SmoothL1Loss", "MaskL1Loss", "l1_loss", "smooth_l1_loss",
              "mask_l1_loss", "reduce_loss"),
}
__all__, __getattr__, __dir__ = export(__name__, _MODULES)
