from .depth_eval import eval_depth
from .face_eval import eval_nme
from .mean_ap import (average_precision, bbox_overlaps_np, eval_map,
                      print_map_summary, tpfp_default)
from .mesh_eval import eval_fscore_points, nn_correspondance
from .recall import eval_recalls, print_recall_summary, set_recall_param

__all__ = [
    "eval_depth",
    "eval_fscore_points",
    "nn_correspondance",
    "eval_nme",
    "average_precision",
    "bbox_overlaps_np",
    "eval_map",
    "print_map_summary",
    "tpfp_default",
    "eval_recalls",
    "print_recall_summary",
    "set_recall_param",
]
