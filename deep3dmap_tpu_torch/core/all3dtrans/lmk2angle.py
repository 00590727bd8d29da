"""Landmark -> pose-angle estimation on the host (the port's numpy copy of
``deep3dmap_tpu/core/all3dtrans/lmk2angle.py``): rotation-matrix checks,
Euler angles, the affine camera's decomposition ``P2sRt``, the
Golden-Standard affine camera from 3D-2D correspondences and the 5-point
face orientation.  The MultiPIE reader takes its ground-truth angles from
``matrix2angle``."""
from __future__ import annotations

import numpy as np

__all__ = [
    "is_rotation_matrix",
    "matrix2angle",
    "R2radangle",
    "P2sRt",
    "estimate_affine_matrix_3d22d",
    "face_orientation",
    "project_param",
]

# canonical 5-point 3D face model (nose tip, eye corners, mouth corners)
_FACE_MODEL_5PT = np.array(
    [
        (0.0, 0.0, 0.0),
        (-165.0, 170.0, -135.0),
        (165.0, 170.0, -135.0),
        (-150.0, -150.0, -125.0),
        (150.0, -150.0, -125.0),
    ]
)


def is_rotation_matrix(R: np.ndarray, tol: float = 1e-6) -> bool:
    """True if R is orthonormal (R^T R == I within tol)."""
    return bool(np.linalg.norm(np.eye(3, dtype=R.dtype) - R.T @ R) < tol)


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


def R2radangle(R: np.ndarray, max_iters: int = 10):
    """Orthonormalize R iteratively, then extract Euler angles in radians.

    Returns (angles[3], is_valid, R); the repair is the SVD projection onto
    SO(3)."""
    R = np.array(R, np.float64, copy=True)
    if not is_rotation_matrix(R):
        for _ in range(max_iters):
            U, _, Vt = np.linalg.svd(R)
            R = U @ Vt
            if np.linalg.det(R) < 0:  # reflection -> flip last axis
                U[:, -1] *= -1
                R = U @ Vt
            if is_rotation_matrix(R):
                break
    deg = matrix2angle(R)
    return np.radians(deg), is_rotation_matrix(R), R


def P2sRt(P: np.ndarray):
    """Decompose a 3x4 affine camera matrix into (scale, R, t)."""
    t = P[:, 3]
    R1, R2 = P[0:1, :3], P[1:2, :3]
    s = (np.linalg.norm(R1) + np.linalg.norm(R2)) / 2.0
    r1 = R1 / np.linalg.norm(R1)
    r2 = R2 / np.linalg.norm(R2)
    r3 = np.cross(r1, r2)
    return s, np.concatenate((r1, r2, r3), 0), t


def estimate_affine_matrix_3d22d(X: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Golden Standard Algorithm (MVGCV Alg. 7.2) for an affine camera P
    from n>=4 3D points X (n,3) and 2D points x (n,2), x = P @ X_homo."""
    X = np.asarray(X, np.float64).T
    x = np.asarray(x, np.float64).T
    n = x.shape[1]
    if X.shape[1] != n or n < 4:
        raise ValueError(f"need n >= 4 matched points, got {X.shape[1]} and {n}")

    # normalize 2d
    mean2 = x.mean(axis=1)
    xc = x - mean2[:, None]
    scale2 = np.sqrt(2) / np.mean(np.linalg.norm(xc, axis=0))
    xn = scale2 * xc
    T = np.array([[scale2, 0, -mean2[0] * scale2],
                  [0, scale2, -mean2[1] * scale2],
                  [0, 0, 1.0]])

    # normalize 3d
    mean3 = X.mean(axis=1)
    Xc = X - mean3[:, None]
    scale3 = np.sqrt(3) / np.mean(np.linalg.norm(Xc, axis=0))
    Xn = scale3 * Xc
    U = np.eye(4)
    U[0, 0] = U[1, 1] = U[2, 2] = scale3
    U[:3, 3] = -mean3 * scale3

    A = np.zeros((2 * n, 8))
    X_homo = np.vstack((Xn, np.ones((1, n)))).T
    A[:n, :4] = X_homo
    A[n:, 4:] = X_homo
    b = xn.reshape(-1, 1)
    p8, *_ = np.linalg.lstsq(A, b, rcond=None)

    P = np.zeros((3, 4))
    P[0, :] = p8[:4, 0]
    P[1, :] = p8[4:, 0]
    P[2, 3] = 1.0
    return np.linalg.inv(T) @ (P @ U)


def face_orientation(landmarks):
    """5-point landmark list [x0,y0,...,x4,y4] (eyeL, eyeR, nose, mouthL,
    mouthR order) -> (roll, pitch, yaw) degrees and the nose position."""
    lm = [v * 2 for v in landmarks]
    image_points = np.array(
        [
            (lm[4], -lm[5]),
            (lm[0], -lm[1]),
            (lm[2], -lm[3]),
            (lm[6], -lm[7]),
            (lm[8], -lm[9]),
        ],
        dtype=np.float64,
    )
    P = estimate_affine_matrix_3d22d(_FACE_MODEL_5PT, image_points)
    _, R, _ = P2sRt(P)
    pitch, yaw, roll = matrix2angle(R)
    return (roll, pitch, yaw), (lm[4], lm[5])


def project_param(landmarks: np.ndarray, template_points: np.ndarray,
                  image_size: int = 224):
    """Estimate (s, R, t) aligning 68-pt template to detected landmarks
    using the 5 stable points [30,36,45,48,54]."""
    idx = [30, 36, 45, 48, 54]
    image_points = np.asarray(landmarks, np.float64)[idx].copy()
    image_points[:, 1] = image_size - image_points[:, 1]
    model_points = np.asarray(template_points, np.float64)[idx]
    P = estimate_affine_matrix_3d22d(model_points, image_points)
    return P2sRt(P)
