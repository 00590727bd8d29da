"""Bundle adjustment: Levenberg-Marquardt with a Schur complement (port of
``deep3dmap_tpu/core/sfm/ba.py``).

- **Static shapes.**  The observation list has a fixed capacity with a
  weight mask: w = 0 slots add nothing to the normal equations.
- **Closed-form Jacobians** per observation, summed into camera and point
  blocks by ``segment_sum``, which adds each segment's rows in observation
  order on the CPU and on the card (an order that changed from run to run
  would change the accept/reject decisions with it).
- **Schur complement as dense einsums** over a [P, C, 6, 3] coupling tensor
  ``U`` (cuBLAS; TF32 off on this path), closed-form 3x3 point inverses, one
  damped ``solve_ex`` of the 6C x 6C reduced system.
- **A fixed number of LM iterations** with branch-free ``torch.where``
  accept/reject: no ``.item()``, no host branch, so ``lm_solve`` runs under
  ``torch.cuda.set_sync_debug_mode("error")``.

Capacity: ``U`` is [P, C, 6, 3] floats, 75.5 MB in float32 at P = 16,384
points and C = 64 cameras, the fragment scale this solver targets; larger
scenes are split into fragments and stitched with :mod:`pose_graph`.

``lm_solve_sharded`` splits the observations over the ranks of a group:
each rank sums its share into the normal-equation blocks, one
``all_reduce`` per iteration assembles them, and the cost is all-reduced
too, so that every rank solves the same system and takes the same accept
decisions.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...utils.device import no_tf32
from .se3 import se3_retract

_DAMP_FIXED = 1e12


class BAProblem(NamedTuple):
    """Fixed-capacity bundle-adjustment problem.

    Attributes:
      K: [C, 4] per-camera intrinsics (fx, fy, cx, cy), held fixed.
      cam_idx: [M] int64 camera index per observation.
      pt_idx: [M] int64 point index per observation.
      uv: [M, 2] observed pixel coordinates.
      w: [M] observation weights; 0 disables a slot.
      cam_fixed: [C] bool, gauge-fixed cameras (pose not updated).
    """
    K: torch.Tensor
    cam_idx: torch.Tensor
    pt_idx: torch.Tensor
    uv: torch.Tensor
    w: torch.Tensor
    cam_fixed: torch.Tensor


def segment_sum(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(data, ids, n)`` for in-range ``ids``, in a fixed
    order on every device: a stable sort by id, then ``segment_reduce``,
    which adds each segment's rows one after another in their order in
    ``data`` (as JAX's scatter-add on the CPU does).  ``index_add_`` adds
    with atomics on the card, and ``index_put_(accumulate=True)`` in
    parallel on the CPU: both change the order from run to run."""
    order = torch.argsort(ids, stable=True)
    offsets = torch.searchsorted(ids[order], torch.arange(n + 1, device=ids.device))
    return torch.segment_reduce(data[order], "sum", offsets=offsets, axis=0, unsafe=True)


def _safe_z(z):
    return torch.where(torch.abs(z) < 1e-6, torch.sign(z) * 1e-6 + 1e-12, z)


def project(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor, X: torch.Tensor):
    """Pinhole projection of world points.  Returns (uv [...,2], z [...])."""
    Xc = torch.einsum("...ij,...j->...i", R, X) + t
    z = Xc[..., 2]
    zs = _safe_z(z)
    u = K[..., 0] * Xc[..., 0] / zs + K[..., 2]
    v = K[..., 1] * Xc[..., 1] / zs + K[..., 3]
    return torch.stack([u, v], -1), z


def reprojection_residuals(R, t, X, prob: BAProblem):
    """Weighted residuals r = w * (proj - uv_obs), shape [M, 2]."""
    Rm, tm = R[prob.cam_idx], t[prob.cam_idx]
    Km, Xm = prob.K[prob.cam_idx], X[prob.pt_idx]
    uv, _ = project(Km, Rm, tm, Xm)
    return (uv - prob.uv) * prob.w[:, None]


def _obs_jacobians(R, t, K, X):
    """Closed-form per-observation Jacobians of the pinhole projection under
    the left-multiplicative pose update (dXc/drho = I, dXc/dw = -hat(Xc),
    dXc/dX = R).  Returns Jc [..., 2, 6] (rho, w), Jp [..., 2, 3], uv [..., 2].
    """
    Xc = torch.einsum("...ij,...j->...i", R, X) + t
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    iz = 1.0 / _safe_z(z)
    fx, fy = K[..., 0], K[..., 1]
    u = fx * x * iz + K[..., 2]
    v = fy * y * iz + K[..., 3]
    zero = torch.zeros_like(iz)
    dpi = torch.stack([
        torch.stack([fx * iz, zero, -fx * x * iz * iz], -1),
        torch.stack([zero, fy * iz, -fy * y * iz * iz], -1),
    ], -2)
    dXc_dw = torch.stack([
        torch.stack([zero, z, -y], -1),
        torch.stack([-z, zero, x], -1),
        torch.stack([y, -x, zero], -1),
    ], -2)
    Jw = dpi @ dXc_dw
    Jc = torch.cat([dpi, Jw], -1)
    Jp = dpi @ R
    return Jc, Jp, torch.stack([u, v], -1)


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate over a signed-floored det):
    no LAPACK, no host sync, JAX's rounding."""
    a = A
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    adj = torch.stack([
        torch.stack([c00, c10, c20], -1),
        torch.stack([c01, c11, c21], -1),
        torch.stack([c02, c12, c22], -1),
    ], -2)
    det = det[..., None, None]
    # where() of two Python floats would round the floor to the default dtype
    return adj / torch.where(det >= 0, det + 1e-12, det - 1e-12)


def _normal_blocks(R, t, X, prob: BAProblem, huber: Optional[float]):
    """Normal-equation blocks from the observation list: (B [C,6,6],
    Cp [P,3,3], U [P,C,6,3], gc [C,6], gp [P,3], cost), each a sum over
    observations."""
    C, P = prob.K.shape[0], X.shape[0]
    Rm, tm = R[prob.cam_idx], t[prob.cam_idx]
    Km, Xm = prob.K[prob.cam_idx], X[prob.pt_idx]
    Jc, Jp, uv = _obs_jacobians(Rm, tm, Km, Xm)
    r = uv - prob.uv
    w = prob.w
    if huber is not None:
        # IRLS Huber: the sqrt-weight scales both r and J
        rn = torch.linalg.vector_norm(r, dim=-1)
        w = w * torch.sqrt(torch.where(rn <= huber, 1.0, huber / (rn + 1e-12)))
    r = r * w[:, None]
    Jc = Jc * w[:, None, None]
    Jp = Jp * w[:, None, None]
    cost = 0.5 * torch.sum(r * r)

    JcT_Jc = torch.einsum("mki,mkj->mij", Jc, Jc)         # [M, 6, 6]
    JpT_Jp = torch.einsum("mki,mkj->mij", Jp, Jp)         # [M, 3, 3]
    W = torch.einsum("mki,mkj->mij", Jc, Jp)              # [M, 6, 3]
    gcm = -torch.einsum("mki,mk->mi", Jc, r)              # [M, 6]
    gpm = -torch.einsum("mki,mk->mi", Jp, r)              # [M, 3]

    B = segment_sum(JcT_Jc, prob.cam_idx, C)
    Cp = segment_sum(JpT_Jp, prob.pt_idx, P)
    gc = segment_sum(gcm, prob.cam_idx, C)
    gp = segment_sum(gpm, prob.pt_idx, P)
    U = segment_sum(W, prob.pt_idx * C + prob.cam_idx, P * C).reshape(P, C, 6, 3)
    return B, Cp, U, gc, gp, cost


def _bdiag(A):
    """Mean of each block's diagonal, for relative (Marquardt) damping."""
    d = torch.diagonal(A, dim1=-2, dim2=-1)
    return torch.mean(d, dim=-1, keepdim=True)[..., None]


def _schur_solve(B, Cp, U, gc, gp, lam, cam_fixed):
    """Solve the damped normal equations by Schur complement onto cameras."""
    C = B.shape[0]
    eye6 = torch.eye(6, dtype=B.dtype, device=B.device)
    eye3 = torch.eye(3, dtype=B.dtype, device=B.device)
    B_d = B + (lam * _bdiag(B) + 1e-8) * eye6
    B_d = B_d + torch.where(cam_fixed[:, None, None], _DAMP_FIXED * eye6, 0.0)
    Cp_d = Cp + (lam * _bdiag(Cp) + 1e-8) * eye3
    Cinv = _inv3x3(Cp_d)                                  # [P, 3, 3]

    # S = B_d - sum_p U_p Cinv_p U_p^T, as camera-pair blocks [C, 6, C, 6]
    Y = torch.einsum("pcij,pjk->pcik", U, Cinv)           # [P, C, 6, 3]
    S = -torch.einsum("pcik,pdlk->cidl", Y, U)
    # the diagonal blocks S[c, :, c, :]: the two index tensors are split by a
    # slice, so (NumPy's rule) their dim comes first: a [C, 6, 6] view
    # indexed [c, i, l], B_d's layout
    cams = torch.arange(C, device=B.device)
    S[cams, :, cams, :] += B_d
    rhs = gc - torch.einsum("pcik,pk->ci", Y, gp)         # [C, 6]

    dxi, _ = torch.linalg.solve_ex(S.reshape(C * 6, C * 6), rhs.reshape(C * 6))
    dxi = torch.where(cam_fixed[:, None], 0.0, dxi.reshape(C, 6))
    # back-substitute the points: dX = Cinv (gp - U^T dxi)
    dX = torch.einsum("pij,pj->pi", Cinv, gp - torch.einsum("pcij,ci->pj", U, dxi))
    return dxi, dX


def robust_cost(r: torch.Tensor, huber: Optional[float]) -> torch.Tensor:
    """The objective of w-weighted residuals ``r`` [M, 2]: half the squared
    norm, or with ``huber`` the Huber loss of the residual norms (the
    objective the IRLS step minimises, so accept/reject compares it)."""
    if huber is None:
        return 0.5 * torch.sum(r * r)
    rn = torch.linalg.vector_norm(r, dim=-1)
    return torch.sum(torch.where(rn <= huber, 0.5 * rn * rn,
                                 huber * (rn - 0.5 * huber)))


class BAResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    X: torch.Tensor
    cost: torch.Tensor
    initial_cost: torch.Tensor
    iterations: torch.Tensor
    lam: torch.Tensor


def lm_solve(R0, t0, X0, prob: BAProblem, iters: int = 20, lam0=1e-3,
             huber: Optional[float] = None, blocks_fn=_normal_blocks,
             cost_fn=None) -> BAResult:
    """Levenberg-Marquardt bundle adjustment on the inputs' device.

    Each of the ``iters`` iterations rebuilds the system at the current
    accepted state, solves the damped step and accepts or rejects it with
    ``torch.where`` (a rejected step raises the damping for the next);
    constant work per iteration and no host sync.  ``lam0`` is a float or a
    0-d tensor (a result's ``lam``, to continue a solve).

    ``blocks_fn(R, t, X, prob, huber)`` builds the normal-equation blocks
    and ``cost_fn(R, t, X)`` the objective: the sharded solve sums both
    over its ranks, and both must, or the ranks' accept decisions would
    part.
    """
    def cost_at(R, t, X):
        if cost_fn is not None:
            return cost_fn(R, t, X)
        return robust_cost(reprojection_residuals(R, t, X, prob), huber)

    with no_tf32():
        c0 = cost_at(R0, t0, X0)
        lam = (lam0.to(X0) if isinstance(lam0, torch.Tensor)
               else torch.full((), lam0, dtype=X0.dtype, device=X0.device))
        R, t, X, cost = R0, t0, X0, c0
        for _ in range(iters):
            B, Cp, U, gc, gp, _ = blocks_fn(R, t, X, prob, huber)
            dxi, dX = _schur_solve(B, Cp, U, gc, gp, lam, prob.cam_fixed)
            R_n, t_n = se3_retract(R, t, dxi)
            X_n = X + dX
            new_cost = cost_at(R_n, t_n, X_n)
            accept = new_cost < cost
            R = torch.where(accept, R_n, R)
            t = torch.where(accept, t_n, t)
            X = torch.where(accept, X_n, X)
            cost = torch.where(accept, new_cost, cost)
            lam = torch.where(accept, torch.clamp(lam * 0.33, min=1e-9),
                              torch.clamp(lam * 4.0, max=1e6))
    iterations = torch.full((), iters, dtype=torch.int32, device=X0.device)
    return BAResult(R, t, X, cost, c0, iterations, lam)


def lm_solve_sharded(mesh, R0, t0, X0, prob: BAProblem, axis: str = "data",
                     iters: int = 20, lam0=1e-3,
                     huber: Optional[float] = None) -> BAResult:
    """Multi-GPU LM: the observations split over ``axis`` (a ``Mesh`` axis,
    or ``mesh`` is that axis's process group itself), one ``all_reduce`` of
    (B, Cp, U, gc, gp) per iteration and one of each cost.

    Every rank passes the whole problem and the same start; it keeps its
    contiguous share of the observations, M padded to a multiple of the
    ranks with w = 0 slots (camera 0 and point 0, which add nothing).  The
    replicated solve then runs the same on every rank, and each returns
    the whole result.
    """
    from ...parallel import collectives
    from ...parallel.mesh import Mesh

    group = mesh.group(axis) if isinstance(mesh, Mesh) else mesh
    n, r = collectives.group_size(group), collectives.group_rank(group)
    M = prob.cam_idx.shape[0]
    pad = (-M) % n
    if pad:
        prob = prob._replace(
            cam_idx=torch.cat([prob.cam_idx, prob.cam_idx.new_zeros(pad)]),
            pt_idx=torch.cat([prob.pt_idx, prob.pt_idx.new_zeros(pad)]),
            uv=torch.cat([prob.uv, prob.uv.new_zeros((pad, 2))]),
            w=torch.cat([prob.w, prob.w.new_zeros(pad)]))
    k = (M + pad) // n
    shard = prob._replace(cam_idx=prob.cam_idx[r * k:(r + 1) * k],
                          pt_idx=prob.pt_idx[r * k:(r + 1) * k],
                          uv=prob.uv[r * k:(r + 1) * k], w=prob.w[r * k:(r + 1) * k])

    def summed_blocks(R, t, X, prob_shard, huber_):
        parts = _normal_blocks(R, t, X, prob_shard, huber_)
        flat = torch.cat([p.reshape(-1) for p in parts[:5]])
        collectives.all_reduce(flat, group)
        out, off = [], 0
        for p in parts[:5]:
            out.append(flat[off:off + p.numel()].view_as(p))
            off += p.numel()
        return (*out, parts[5])

    def summed_cost(R, t, X):
        c = robust_cost(reprojection_residuals(R, t, X, shard), huber)
        return collectives.all_reduce(c.reshape(1), group)[0]

    return lm_solve(R0, t0, X0, shard, iters=iters, lam0=lam0, huber=huber,
                    blocks_fn=summed_blocks, cost_fn=summed_cost)
