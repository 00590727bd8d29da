"""The port's ops: every name of the JAX package's ``ops/__init__.py``.

Each is imported from its module at first use, so importing a submodule
alone (the host C++ op in the evaluation's torch-free workers, or the host
post-processing of ``ops/host.py``) imports no torch."""
import importlib
import sys
import types

_MODULES = {
    "back_project": ("back_project_dense",),
    "grid_sample": ("grid_sample_2d", "grid_sample_3d"),
    "raster": ("raster_depth_st", "raster_grid_depth_hard", "splat_depth_soft"),
    "bbox": ("bbox_overlaps", "nms", "soft_nms", "batched_nms", "nms_match", "nms_rotated",
             "box_iou_rotated"),
    "focal_loss": ("sigmoid_focal_loss", "softmax_focal_loss"),
    "points": ("knn", "ball_query", "furthest_point_sample", "gather_points", "group_points",
               "three_nn", "three_interpolate", "three_interpolate_weights",
               "square_distance"),
    "roi_align": ("roi_align", "roi_align_rotated", "roi_pool"),
    "voxel": ("voxelize", "voxelize_host", "dynamic_scatter", "points_in_boxes"),
    "deform": ("deform_conv2d", "modulated_deform_conv2d", "deform_roi_pool",
               "ms_deform_attn"),
    "vision": ("carafe", "carafe_naive", "masked_conv2d", "correlation", "tin_shift",
               "psamask", "border_align", "corner_pool"),
    "box3d": ("boxes_iou_bev", "boxes_overlap_bev", "boxes_iou3d", "nms3d", "nms3d_normal",
              "roiaware_pool3d", "roipoint_pool3d"),
    "host": ("pixel_group", "contour_expand"),
}
_HOME = {name: mod for mod, names in _MODULES.items() for name in names}

__all__ = list(_HOME)


class _Ops(types.ModuleType):
    def __setattr__(self, name, value):
        # importing the submodule ``roi_align`` binds it on the package:
        # keep the function of that name there, as the JAX package's eager
        # import does (the module stays in ``sys.modules``)
        if (isinstance(value, types.ModuleType) and name in _HOME
                and value.__name__ == f"{__name__}.{name}"):
            value = getattr(value, name)
        super().__setattr__(name, value)


sys.modules[__name__].__class__ = _Ops


def __getattr__(name):
    if name in _HOME:
        value = getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"), name)
        globals()[name] = value                   # cached
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
