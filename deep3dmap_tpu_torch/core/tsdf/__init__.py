"""TSDF fusion (the names of ``deep3dmap_tpu/core/tsdf/__init__.py``),
exported lazily."""
from ..._lazy import export

_MODULES = {"fusion": ("TSDFParams", "tsdf_integrate", "tsdf_fuse_frames",
                       "tsdf_pyramid_from_depths")}
__all__, __getattr__, __dir__ = export(__name__, _MODULES)
