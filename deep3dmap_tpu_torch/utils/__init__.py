"""The port's utilities (the names of ``deep3dmap_tpu/utils/__init__.py``),
exported lazily, so the torch-free helpers (``registry``, ``config``,
``image_ops``, ``fileio``) import no torch."""
from .._lazy import export

_MODULES = {
    "registry": ("Registry", "build_from_cfg"),
    "config": ("Config", "ConfigDict"),
    "logging": ("get_root_logger",),
    "log_buffer": ("LogBuffer",),
    "meters": ("AverageMeter", "StandardMetrics"),
    "message_hub": ("MessageHub", "HistoryBuffer"),
    "analysis": ("count_params", "get_model_complexity_info"),
    "weight_init": ("build_initializer", "apply_init_cfg"),
    "structures": ("BaseDataElement", "InstanceData", "PixelData"),
}
__all__, __getattr__, __dir__ = export(__name__, _MODULES)
__all__.append("fileio")
