"""``diff_augment`` (the name of
``deep3dmap_tpu/models/function_utils/__init__.py``), exported lazily."""
from ..._lazy import export

_MODULES = {"diff_augment": ("diff_augment",)}
__all__, __getattr__, __dir__ = export(__name__, _MODULES)
