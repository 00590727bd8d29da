"""Visualisation (port of ``deep3dmap_tpu/core/visualize/``): mesh previews
and the live viewer, camera plots, the ``Visualizer`` and its backends."""
from .camera_scene import plot_camera_scene
from .mesh_viewer import LiveMeshViewer, save_mesh_preview
from .visualizer import (VISBACKENDS, BaseVisBackend, LocalVisBackend, MlflowVisBackend,
                         TensorboardVisBackend, Visualizer, WandbVisBackend)

__all__ = ["plot_camera_scene", "save_mesh_preview", "LiveMeshViewer", "Visualizer",
           "VISBACKENDS", "BaseVisBackend", "LocalVisBackend", "TensorboardVisBackend",
           "WandbVisBackend", "MlflowVisBackend"]
