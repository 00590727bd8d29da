"""The UV sampler (the names of ``deep3dmap_tpu/core/renderer/__init__.py``),
exported lazily."""
from ..._lazy import export

_MODULES = {"uv_sampler": ("UVRasterization", "precompute_uv_rasterization",
                           "sample_uv_texture")}
__all__, __getattr__, __dir__ = export(__name__, _MODULES)
