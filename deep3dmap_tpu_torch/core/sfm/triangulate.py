"""Batched multi-view triangulation and two-view geometry (port of
``deep3dmap_tpu/core/sfm/triangulate.py``).

Fixed-capacity per-point view lists with masks; the DLT system is solved
as inhomogeneous 3x3 normal equations with the closed-form inverse.  The
eight-point essential matrix is the smallest eigenvector of the 9x9 scatter
matrix, and RANSAC solves all its hypotheses as one batched ``eigh``.

``torch.linalg.eigh`` on the card reads its ``info`` back to the host: one
sync per call (a RANSAC is four calls, ``recover_pose`` one).  Nothing else
here syncs: constants are made on the device, the winners are picked with
``argmax`` and gathers.  Eigenvectors are defined up to sign, so LAPACK,
torch's CPU path and cuSOLVER may return E with either sign; the Sampson
distances, the inliers and ``recover_pose``'s (R, t) do not depend on it.
"""
from __future__ import annotations

from typing import Optional

import torch

from .ba import _inv3x3
from .se3 import se3_compose, se3_inverse


def _projection_rows(K, R, t, uv):
    """Two DLT rows per view: A [..., 2, 3], b [..., 2] for A X = b."""
    fx, fy, cx, cy = K[..., 0], K[..., 1], K[..., 2], K[..., 3]
    P0 = fx[..., None] * R[..., 0, :] + cx[..., None] * R[..., 2, :]
    P1 = fy[..., None] * R[..., 1, :] + cy[..., None] * R[..., 2, :]
    P2 = R[..., 2, :]
    p0t = fx * t[..., 0] + cx * t[..., 2]
    p1t = fy * t[..., 1] + cy * t[..., 2]
    p2t = t[..., 2]
    u, v = uv[..., 0], uv[..., 1]
    A = torch.stack([u[..., None] * P2 - P0, v[..., None] * P2 - P1], -2)
    b = torch.stack([p0t - u * p2t, p1t - v * p2t], -1)
    return A, b


def triangulate(K, R, t, uv, mask):
    """Multi-view DLT triangulation.

    Args:
      K: [P, V, 4] intrinsics per (point, view) slot.
      R, t: [P, V, 3, 3], [P, V, 3] world->camera poses.
      uv: [P, V, 2] observations; mask: [P, V] validity (needs >= 2 views).

    Returns X [P, 3] world points (zeros where under-constrained).
    """
    A, b = _projection_rows(K, R, t, uv)
    m = mask[..., None, None]
    AtA = torch.sum(torch.einsum("pvki,pvkj->pvij", A, A) * m, 1)
    Atb = torch.sum(torch.einsum("pvki,pvk->pvi", A, b) * mask[..., None], 1)
    ok = torch.sum(mask, -1) >= 2
    X = torch.einsum("pij,pj->pi", _inv3x3(AtA), Atb)
    return torch.where(ok[:, None], X, 0.0)


def triangulate_two_view(K1, R1, t1, K2, R2, t2, uv1, uv2):
    """Pairwise triangulation of matched points ([N,2] each) -> X [N,3]."""
    N = uv1.shape[0]
    K = torch.stack([K1.expand(N, 4), K2.expand(N, 4)], 1)
    R = torch.stack([R1.expand(N, 3, 3), R2.expand(N, 3, 3)], 1)
    t = torch.stack([t1.expand(N, 3), t2.expand(N, 3)], 1)
    uv = torch.stack([uv1, uv2], 1)
    return triangulate(K, R, t, uv, uv1.new_ones((N, 2)))


def normalize_points(uv, K):
    """Pixels -> normalized camera coordinates given [4] intrinsics."""
    return torch.stack([(uv[..., 0] - K[2]) / K[0], (uv[..., 1] - K[3]) / K[1]], -1)


def essential_eight_point(x1, x2, w=None):
    """Weighted eight-point essential matrix from normalized correspondences.

    x1, x2: [..., N, 2] normalized coords; w: [..., N] weights (0 = inert
    slot).  Returns E [..., 3, 3] with the essential structure (two equal
    singular values, the third 0): the smallest eigenvector of the 9x9
    scatter A^T W A, projected.  Leading dims are independent problems
    (RANSAC's hypotheses).
    """
    if w is None:
        w = x1.new_ones(x1.shape[:-1])
    one = torch.ones_like(w)
    u1, v1, u2, v2 = x1[..., 0], x1[..., 1], x2[..., 0], x2[..., 1]
    # x2^T E x1 = 0 rows
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], -1)
    AtA = torch.einsum("...ni,...nj->...ij", A * w[..., None], A)
    _, vecs = torch.linalg.eigh(AtA)
    E = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    U, S, Vt = _svd3(E)
    s = (S[..., 0] + S[..., 1]) * 0.5
    return U @ torch.diag_embed(torch.stack([s, s, torch.zeros_like(s)], -1)) @ Vt


def sampson_distance(E, x1, x2):
    """First-order epipolar (Sampson) distance of normalized coords [N,2]
    under E [..., 3, 3]: [..., N]."""
    ones = x1.new_ones(x1.shape[:-1] + (1,))
    h1 = torch.cat([x1, ones], -1)
    h2 = torch.cat([x2, ones], -1)
    Ex1 = torch.einsum("...ij,nj->...ni", E, h1)
    Etx2 = torch.einsum("...ji,nj->...ni", E, h2)
    num = torch.einsum("ni,...ni->...n", h2, Ex1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / (den + 1e-12)


def _hypothesis_uniforms(generator: Optional[torch.Generator], n_hypotheses: int,
                         like: torch.Tensor) -> torch.Tensor:
    """RANSAC's only draw: [H, N] uniforms in [1e-9, 1) from ``generator`` on
    ``like``'s device and in its dtype (``jax.random.uniform(key, (H, N),
    minval=1e-9, maxval=1.0)`` in JAX)."""
    g = torch.rand((n_hypotheses, like.shape[0]), generator=generator,
                   dtype=like.dtype, device=like.device)
    return g * (1.0 - 1e-9) + 1e-9


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last dim, largest
    first, the lower index first among equal values (``jax.lax.top_k``'s
    rule; ``-inf`` padding ties), by a stable descending sort."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def essential_ransac(x1, x2, generator: Optional[torch.Generator], w=None,
                     n_hypotheses: int = 256, thresh: float = 1e-3):
    """Robust essential-matrix estimation, fully batched, no host loop.

    All ``n_hypotheses`` minimal 8-point sets are drawn at once without
    replacement from the valid (w > 0) slots (Gumbel-top-k over per-slot
    uniforms), solved as one batched eigh, and scored against every
    correspondence in one [H, N] Sampson computation; the best hypothesis's
    inliers drive one weighted refit.

    Args:
      x1, x2: [N, 2] normalized correspondences.
      generator: the ``torch.Generator`` (on the inputs' device) of the
        draw, JAX's key; ``None`` draws from torch's global generator.
      w: [N] validity weights (0 = inert slot, never sampled or scored).
      thresh: Sampson inlier threshold in normalized units (~pixels / focal).

    Returns (E [3,3], inliers [N] bool).
    """
    N = x1.shape[0]
    if w is None:
        w = x1.new_ones(N)
    g = _hypothesis_uniforms(generator, n_hypotheses, x1)
    logits = torch.log(g) + torch.where(w > 0, 0.0, float("-inf"))
    idx = top_k_indices(logits, 8)                          # [H, 8]
    Es = essential_eight_point(x1[idx], x2[idx], w[idx])    # [H, 3, 3]
    d = sampson_distance(Es, x1, x2)                        # [H, N]
    inl = (d < thresh) & (w > 0)
    scores = torch.sum(inl, dim=1)
    best = torch.argmax(scores)                             # the first of equal scores
    best_inl = inl[best[None]][0]
    E = essential_eight_point(x1, x2, w * best_inl.to(x1.dtype))
    inliers = (sampson_distance(E, x1, x2) < thresh) & (w > 0)
    return E, inliers


def _svd3(M):
    """3x3 SVD through eigh of M^T M: M = U diag(S) V^T, S descending,
    batched over leading dims.

    U is rebuilt by Gram-Schmidt and a cross product, not by dividing by
    the singular values: for the near-rank-2 matrices fed here, M v2 / S2
    would amplify float32 noise into a garbage column.
    """
    evals, V = torch.linalg.eigh(M.transpose(-1, -2) @ M)  # ascending
    evals, V = evals.flip(-1), V.flip(-1)
    S = torch.sqrt(torch.clamp(evals, min=0.0))
    u0 = (M @ V[..., :, 0:1])[..., 0]
    u0 = u0 / (torch.linalg.vector_norm(u0, dim=-1, keepdim=True) + 1e-12)
    u1 = (M @ V[..., :, 1:2])[..., 0]
    u1 = u1 - torch.sum(u1 * u0, -1, keepdim=True) * u0
    u1 = u1 / (torch.linalg.vector_norm(u1, dim=-1, keepdim=True) + 1e-12)
    u2 = torch.linalg.cross(u0, u1, dim=-1)
    return torch.stack([u0, u1, u2], -1), S, V.transpose(-1, -2)


def _det3(M):
    """Closed-form 3x3 determinant (``linalg.det`` factorizes, and may sync)."""
    return torch.sum(M[..., 0, :] * torch.linalg.cross(M[..., 1, :], M[..., 2, :], dim=-1), -1)


def recover_pose(E, x1, x2, w=None):
    """Decompose E into the cheirality-consistent (R, t), |t| = 1.

    Returns (R, t) mapping camera-1 coordinates to camera-2: x2 ~ R x1 + t.
    The four (R, t) candidates are scored by the points with positive depth
    in both views; the best is taken with ``argmax`` and a gather.
    """
    N = x1.shape[0]
    if w is None:
        w = x1.new_ones(N)
    U, _, Vt = _svd3(E)
    U = U * torch.sign(_det3(U))
    Vt = Vt * torch.sign(_det3(Vt))
    # constants made on the device: a Python number written into a device
    # tensor's element is a host copy, a sync
    I3 = torch.eye(3, dtype=E.dtype, device=E.device)
    W = torch.stack([-I3[1], I3[0], I3[2]])                # [[0,-1,0],[1,0,0],[0,0,1]]
    Ra, Rb = U @ W @ Vt, U @ W.T @ Vt
    tu = U[:, 2]
    cands = [(Ra, tu), (Ra, -tu), (Rb, tu), (Rb, -tu)]
    Kn = (torch.arange(4, device=E.device) < 2).to(E.dtype)   # normalized intrinsics
    z3 = E.new_zeros(3)

    def score(R, t):
        X = triangulate_two_view(Kn, I3, z3, Kn, R, t, x1, x2)
        z1 = X[:, 2]
        z2 = (torch.einsum("ij,nj->ni", R, X) + t)[:, 2]
        return torch.sum(w * (z1 > 0) * (z2 > 0))

    scores = torch.stack([score(R, t) for R, t in cands])
    best = torch.argmax(scores)[None]
    Rs = torch.stack([c[0] for c in cands])
    ts = torch.stack([c[1] for c in cands])
    return Rs[best][0], ts[best][0]


def relative_pose(R1, t1, R2, t2):
    """Relative transform cam1->cam2 from two world->camera poses."""
    Ri, ti = se3_inverse(R1, t1)
    return se3_compose(R2, t2, Ri, ti)
