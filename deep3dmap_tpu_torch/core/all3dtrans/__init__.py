"""Rotations and landmark poses (the names of
``deep3dmap_tpu/core/all3dtrans/__init__.py``), exported lazily."""
from ..._lazy import export

_MODULES = {
    "rotations": ("euler_angles_to_matrix", "matrix_to_euler_angles"),
    "lmk2angle": ("P2sRt", "R2radangle", "estimate_affine_matrix_3d22d", "face_orientation",
                  "is_rotation_matrix", "matrix2angle", "project_param"),
}
__all__, __getattr__, __dir__ = export(__name__, _MODULES)
