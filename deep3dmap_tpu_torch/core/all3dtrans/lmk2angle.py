"""Rotation matrix -> pose angles on the host (the port's numpy copy of
``deep3dmap_tpu/core/all3dtrans/lmk2angle.py::matrix2angle``, :41), which the
MultiPIE reader uses for its ground-truth angles."""
from __future__ import annotations

import numpy as np


def matrix2angle(R: np.ndarray):
    """Rotation matrix -> (pitch, yaw, roll) in degrees."""
    sy = float(np.hypot(R[0, 0], R[1, 0]))
    if sy >= 1e-6:
        x = np.arctan2(R[2, 1], R[2, 2])
        y = np.arctan2(-R[2, 0], sy)
        z = np.arctan2(R[1, 0], R[0, 0])
    else:
        x = np.arctan2(-R[1, 2], R[1, 1])
        y = np.arctan2(-R[2, 0], sy)
        z = 0.0
    return tuple(np.degrees([x, y, z]))
