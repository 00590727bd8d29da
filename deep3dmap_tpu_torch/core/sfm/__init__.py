"""The SfM / pose-estimation layer on tensors (port of
``deep3dmap_tpu/core/sfm/``): features, two-view geometry with batched
RANSAC, triangulation, Schur-complement bundle adjustment and pose-graph
optimization.  The pipelines consume given poses; this layer estimates and
refines them.  ``deep3dmap_tpu_torch/tools/benchmark_ba.py`` reports BA
iterations per second; ``lm_solve_sharded`` splits the observations over
the ranks of a process group.
"""
from .ba import BAProblem, BAResult, lm_solve, lm_solve_sharded, project, \
    reprojection_residuals
from .features import Keypoints, Matches, detect_keypoints, \
    extract_descriptors, harris_response, match_descriptors, match_images
from .pose_graph import PoseGraph, compose_chain, edge_residual, graph_cost, \
    odometry_graph, optimize
from .se3 import se3_compose, se3_exp, se3_inverse, se3_log, se3_retract, \
    so3_exp, so3_log, transform_points
from .triangulate import essential_eight_point, essential_ransac, \
    normalize_points, recover_pose, relative_pose, sampson_distance, \
    triangulate, triangulate_two_view

__all__ = [
    "BAProblem", "BAResult", "lm_solve", "lm_solve_sharded", "project",
    "reprojection_residuals", "Keypoints", "Matches", "detect_keypoints",
    "extract_descriptors", "harris_response", "match_descriptors",
    "match_images", "PoseGraph", "compose_chain", "edge_residual",
    "graph_cost", "odometry_graph", "optimize", "se3_compose", "se3_exp",
    "se3_inverse", "se3_log", "se3_retract", "so3_exp", "so3_log",
    "transform_points", "essential_eight_point", "normalize_points",
    "recover_pose", "relative_pose", "triangulate", "triangulate_two_view",
    "essential_ransac", "sampson_distance",
]
