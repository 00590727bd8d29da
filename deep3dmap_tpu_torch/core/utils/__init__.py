"""Meshes and scenes (the names of ``deep3dmap_tpu/core/utils/__init__.py``),
exported lazily: ``scene_eval``'s torch-free workers import ``io_ply``
alone."""
from ..._lazy import export

_MODULES = {
    "marching_cubes": ("marching_tetrahedra", "tsdf_to_mesh"),
    "scene_assembler": ("SceneAssembler",),
    "io_ply": ("write_ply", "read_ply"),
}
__all__, __getattr__, __dir__ = export(__name__, _MODULES)
