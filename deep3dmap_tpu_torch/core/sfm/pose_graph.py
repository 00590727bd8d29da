"""Pose-graph optimization of a fragment or keyframe trajectory on the
device (port of ``deep3dmap_tpu/core/sfm/pose_graph.py``).

Nodes are SE(3) poses T_i (node -> world), edges relative measurements
Z_ij ~ T_i^{-1} T_j with scalar weights (w = 0 slots inert).  Each edge's
6x12 Jacobian is forward-mode autodiff of the retraction
(``torch.func.vmap(torch.func.jacfwd(...))`` over the edges, through
``so3_log``'s three branches); the Gauss-Newton normal equations are summed
into a dense [6N, 6N] system in a fixed order and solved with ``solve_ex``.
A fixed number of LM iterations, accept/reject by ``torch.where``: no host
sync.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ...utils.device import no_tf32
from .ba import segment_sum
from .se3 import se3_compose, se3_inverse, se3_log, se3_retract


class PoseGraph(NamedTuple):
    """Edges i->j with measured relative pose (Rz, tz) = Z_ij ~ T_i^{-1} T_j.

    Attributes:
      i, j: [E] int64 node indices.
      Rz: [E, 3, 3]; tz: [E, 3] measured relative transforms.
      w: [E] edge weights (0 disables).
    """
    i: torch.Tensor
    j: torch.Tensor
    Rz: torch.Tensor
    tz: torch.Tensor
    w: torch.Tensor


def edge_residual(Ri, ti, Rj, tj, Rz, tz):
    """r = log(Z^{-1} . T_i^{-1} . T_j) in R^6, batched over leading dims."""
    Rzi, tzi = se3_inverse(Rz, tz)
    Rii, tii = se3_inverse(Ri, ti)
    Rr, tr = se3_compose(Rii, tii, Rj, tj)
    Rr, tr = se3_compose(Rzi, tzi, Rr, tr)
    return se3_log(Rr, tr)


def graph_cost(R, t, g: PoseGraph):
    r = edge_residual(R[g.i], t[g.i], R[g.j], t[g.j], g.Rz, g.tz)
    return 0.5 * torch.sum(g.w[:, None] * r * r)


def _edge_linearize(Ri, ti, Rj, tj, Rz, tz):
    """One edge's residual and Jacobians with respect to left-multiplicative
    increments on i and j: (r [6], Ji [6, 6], Jj [6, 6])."""
    # every intermediate keeps a leading dim of 1: torch.func's jvp of a
    # 0-d float32 tensor and a Python float gives a float64 tangent
    def f(xi):
        Ri_, ti_ = se3_retract(Ri[None], ti[None], xi[None, :6])
        Rj_, tj_ = se3_retract(Rj[None], tj[None], xi[None, 6:])
        return edge_residual(Ri_, ti_, Rj_, tj_, Rz[None], tz[None])[0]

    J = jacfwd(f)(ti.new_zeros(12))                     # [6, 12]
    r = edge_residual(Ri, ti, Rj, tj, Rz, tz)
    return r, J[:, :6], J[:, 6:]


def optimize(R0, t0, g: PoseGraph, iters: int = 15, lam0: float = 1e-4,
             anchor: int = 0):
    """Gauss-Newton/LM pose-graph optimization; node ``anchor`` is held.

    Returns (R [N,3,3], t [N,3], cost, initial_cost).
    """
    N = t0.shape[0]
    dev, dt = t0.device, t0.dtype

    def build(R, t):
        r, Ji, Jj = vmap(_edge_linearize)(R[g.i], t[g.i], R[g.j], t[g.j], g.Rz, g.tz)
        w = g.w[:, None, None]
        Hii = torch.einsum("eki,ekj->eij", Ji, Ji) * w
        Hjj = torch.einsum("eki,ekj->eij", Jj, Jj) * w
        Hij = torch.einsum("eki,ekj->eij", Ji, Jj) * w
        # block scatter into N*N (node, node) segments, in a fixed order
        flat = segment_sum(
            torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)], 0),
            torch.cat([g.i * N + g.i, g.j * N + g.j, g.i * N + g.j, g.j * N + g.i], 0),
            N * N)
        H = flat.reshape(N, N, 6, 6).permute(0, 2, 1, 3)
        rw = r * g.w[:, None]
        b = -(segment_sum(torch.einsum("eki,ek->ei", Ji, rw), g.i, N)
              + segment_sum(torch.einsum("eki,ek->ei", Jj, rw), g.j, N))
        return H, b

    anchor_mask = torch.arange(N, device=dev) == anchor
    # gauge fix: huge damping on the anchor block
    anchor_damp = torch.diag(torch.where(torch.repeat_interleave(anchor_mask, 6),
                                         torch.full((6 * N,), 1e12, dtype=dt, device=dev),
                                         0.0))
    eye = torch.eye(N * 6, dtype=dt, device=dev)
    with no_tf32():
        c0 = graph_cost(R0, t0, g)
        R, t, cost = R0, t0, c0
        lam = torch.full((), lam0, dtype=dt, device=dev)
        for _ in range(iters):
            H, b = build(R, t)
            H = H.reshape(N * 6, N * 6)
            damp = lam * torch.mean(torch.diagonal(H)) + 1e-8
            Hd = H + damp * eye + anchor_damp
            dx, _ = torch.linalg.solve_ex(Hd, b.reshape(N * 6))
            dx = torch.where(anchor_mask[:, None], 0.0, dx.reshape(N, 6))
            R_n, t_n = se3_retract(R, t, dx)
            new_cost = graph_cost(R_n, t_n, g)
            accept = new_cost < cost
            R = torch.where(accept, R_n, R)
            t = torch.where(accept, t_n, t)
            cost = torch.where(accept, new_cost, cost)
            lam = torch.where(accept, torch.clamp(lam * 0.33, min=1e-10),
                              torch.clamp(lam * 4.0, max=1e6))
    return R, t, cost, c0


def odometry_graph(R_rel, t_rel, w=None):
    """Chain graph from N-1 consecutive relative poses."""
    E = t_rel.shape[0]
    i = torch.arange(E, device=t_rel.device)
    if w is None:
        w = t_rel.new_ones(E)
    return PoseGraph(i=i, j=i + 1, Rz=R_rel, tz=t_rel, w=w)


def compose_chain(R_rel, t_rel):
    """Integrate N-1 relative poses into an absolute trajectory of N
    (T_0 = identity)."""
    R = torch.eye(3, dtype=t_rel.dtype, device=t_rel.device)
    t = t_rel.new_zeros(3)
    Rs, ts = [R], [t]
    for k in range(t_rel.shape[0]):
        R, t = se3_compose(R, t, R_rel[k], t_rel[k])
        Rs.append(R)
        ts.append(t)
    return torch.stack(Rs), torch.stack(ts)
