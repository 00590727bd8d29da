"""The port's ops.  The box ops of ``ops/bbox.py`` are exported here, as the
JAX package's ``ops/__init__.py`` exports them; they are imported at first
use, so importing a submodule (the host C++ op in the evaluation's torch-free
workers) imports no torch."""
_BBOX = ("bbox_overlaps", "nms", "soft_nms", "batched_nms", "nms_match", "nms_rotated",
         "box_iou_rotated")

__all__ = list(_BBOX)


def __getattr__(name):
    if name in _BBOX:
        from . import bbox
        return getattr(bbox, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
