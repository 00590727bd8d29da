"""The BFM tools (the names of ``deep3dmap_tpu/core/all3dmm/__init__.py``),
exported lazily."""
from ..._lazy import export

_MODULES = {"bfm_tools": ("BFMModel", "param2points_bfm", "load_bfm_mat", "make_synthetic_bfm")}
__all__, __getattr__, __dir__ = export(__name__, _MODULES)
