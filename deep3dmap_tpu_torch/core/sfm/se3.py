"""SE(3)/SO(3) Lie-group maps on tensors (port of
``deep3dmap_tpu/core/sfm/se3.py``), batch-broadcastable over leading dims.

Closed forms (Rodrigues) made branch-free with ``torch.where`` and Taylor
fallbacks near theta = 0.  ``torch.where`` evaluates both branches, as
``jnp.where`` does, so the guards are JAX's as written: the sqrt argument
is replaced inside the guarded region (no additive eps), and ``so3_log``
feeds its exact branch a guarded argument so no ``inf`` reaches a tangent
near the identity (``pose_graph.py`` differentiates exactly there with
``torch.func.jacfwd``).  No host sync, no data-dependent control flow.
"""
from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (...,3) -> (...,3,3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (...,3,3) -> (...,3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)




def _sinc_coeffs(theta2: torch.Tensor):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t-sin t)/t^3), Taylor-safe.

    Inside ``theta2 < 1e-6`` the sqrt argument is replaced by 1.0 (an
    additive eps would bias theta for small nonzero angles, amplified by
    ``se3_log``'s V-inverse cancellation); the Taylor branch carries the
    t^4 term.
    """
    small = theta2 < 1e-6
    safe2 = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(safe2)
    A = torch.where(small, 1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0,
                    torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0,
                    (1.0 - torch.cos(theta)) / safe2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
                    (theta - torch.sin(theta)) / (safe2 * theta))
    return A, B, C


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation."""
    theta2 = torch.sum(w * w, -1)
    A, B, _ = _sinc_coeffs(theta2)
    W = hat(w)
    return _eye3(w) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) rotation -> (...,3) axis-angle (|w| <= pi).

    Three branches blended with ``torch.where``: the Taylor series of
    theta/(2 sin theta) near 0; theta/(2 sin theta) vee(R - R^T) in
    general; near pi the axis from the dominant column of R + I,
    sign-aligned with vee(R - R^T).  arccos and sqrt have infinite slope
    at |cos| = 1, so the exact branch reads a guarded cosine (double
    ``where``).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    v = vee(R - R.transpose(-1, -2))              # = 2 sin(theta) * axis
    small = cos_t > 1.0 - 1e-4                    # theta < ~1.4e-2
    near_pi = cos_t < -1.0 + 1e-5                 # theta > pi - ~4.5e-3
    c_gen = torch.where(small | near_pi, 0.0, cos_t)
    theta_gen = torch.arccos(c_gen)
    sin_gen = torch.sqrt(1.0 - c_gen * c_gen)
    # scale = theta/(2 sin theta) as a series in e = 1 - cos(theta)
    e = 1.0 - cos_t
    scale = torch.where(small, 0.5 + e / 6.0 + e * e / 15.0,
                        theta_gen / (2.0 * sin_gen))
    w_generic = scale[..., None] * v

    # near pi: R + I = 2 axis axis^T + (1 + cos t)(I - axis axis^T) + sin t hat(axis)
    S = R + _eye3(R)
    diag = torch.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], -1)
    k = torch.argmax(diag, dim=-1)                # the first of equal entries
    col = torch.gather(S, -1, k[..., None, None].expand(*S.shape[:-1], 1))[..., 0]
    norm = torch.sqrt(torch.sum(col * col, -1, keepdim=True))
    axis = col / torch.where(norm < 1e-12, 1.0, norm)
    sign = torch.where(torch.sum(axis * v, -1, keepdim=True) < 0.0, -1.0, 1.0)
    theta_pi = torch.arccos(torch.clamp(cos_t, -1.0 + 1e-7, -0.5))
    w_pi = theta_pi[..., None] * axis * sign
    return torch.where(near_pi[..., None], w_pi, w_generic)


def se3_exp(xi: torch.Tensor):
    """Twist (...,6) [rho, w] -> (R (...,3,3), t (...,3))."""
    rho, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, -1)
    A, B, C = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    I = _eye3(xi)
    R = I + A[..., None, None] * W + B[..., None, None] * W2
    V = I + B[..., None, None] * W + C[..., None, None] * W2
    t = torch.einsum("...ij,...j->...i", V, rho)
    return R, t


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> twist (...,6) [rho, w]."""
    w = so3_log(R)
    theta2 = torch.sum(w * w, -1)
    A, B, _ = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    # V^{-1} = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2; the exact coefficient
    # cancels catastrophically near theta = 0, so it has its own series
    small = theta2 < 1e-6
    safe2 = torch.where(small, 1.0, theta2)
    coef = torch.where(small,
                       1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0,
                       (1.0 - A / (2.0 * B)) / safe2)
    Vinv = _eye3(R) - 0.5 * W + coef[..., None, None] * W2
    rho = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([rho, w], -1)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra,ta) * (Rb,tb): first apply b, then a."""
    return Ra @ Rb, torch.einsum("...ij,...j->...i", Ra, tb) + ta


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def se3_retract(R0, t0, xi):
    """Left-multiplicative retraction exp(xi) * (R0, t0): a world-frame
    increment, as the Jacobians of ``ba.py`` and ``pose_graph.py`` take it."""
    dR, dt = se3_exp(xi)
    return se3_compose(dR, dt, R0, t0)


def transform_points(R, t, X):
    """Apply (...,3,3),(...,3) to points (...,N,3)."""
    return torch.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
