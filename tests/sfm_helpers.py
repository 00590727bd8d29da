"""Shared inputs of the SfM parity tests (tests/test_torch_sfm*.py), made
in numpy from a seed so both sides read the same arrays.

``ring_scene`` is ``tests/test_sfm.py:82-107``'s scene: cameras on an arc
around points near the origin, every point seen by every camera.
``pose_ring`` is ``tests/test_sfm.py:251-276``'s graph: noisy odometry
between ground-truth poses plus exact loop closures.  ``accept_prefix``
says how many of an LM run's accept/reject decisions both sides must
share.
"""
from typing import NamedTuple

import numpy as np
import torch

DECIDED = 1e-12     # a cost change below this (relative) is rounding


class NpBAProblem(NamedTuple):
    K: np.ndarray
    cam_idx: np.ndarray
    pt_idx: np.ndarray
    uv: np.ndarray
    w: np.ndarray
    cam_fixed: np.ndarray


class NpPoseGraph(NamedTuple):
    i: np.ndarray
    j: np.ndarray
    Rz: np.ndarray
    tz: np.ndarray
    w: np.ndarray


def rodrigues(w):
    """so3_exp in numpy, (..., 3) -> (..., 3, 3)."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w, axis=-1)[..., None, None]
    W = np.zeros(w.shape[:-1] + (3, 3))
    W[..., 0, 1], W[..., 0, 2], W[..., 1, 2] = -w[..., 2], w[..., 1], -w[..., 0]
    W = W - np.swapaxes(W, -1, -2)
    safe = np.where(th < 1e-12, 1.0, th)
    A = np.where(th < 1e-12, 1.0, np.sin(safe) / safe)
    B = np.where(th < 1e-12, 0.5, (1.0 - np.cos(safe)) / (safe * safe))
    return np.eye(3) + A * W + B * (W @ W)


def project(K, R, t, X):
    Xc = np.einsum("...ij,...j->...i", R, X) + t
    uv = np.stack([K[..., 0] * Xc[..., 0] / Xc[..., 2] + K[..., 2],
                   K[..., 1] * Xc[..., 1] / Xc[..., 2] + K[..., 3]], -1)
    return uv, Xc[..., 2]


def ring_scene(rng, n_cams=6, n_pts=64, noise=0.5):
    """(K, Rs, ts, X, NpBAProblem): ``noise`` px of Gaussian noise on the
    observations, the first two cameras fixed."""
    X = rng.randn(n_pts, 3) * 0.6
    K = np.tile(np.array([320.0, 320.0, 160.0, 120.0]), (n_cams, 1))
    Rs, ts = [], []
    for i in range(n_cams):
        ang = 0.4 * i / max(n_cams - 1, 1)
        R = rodrigues([0.0, ang, 0.0])
        c = np.array([2.5 * np.sin(ang), 0.1 * i, -2.5 * np.cos(ang)])
        Rs.append(R)
        ts.append(-R @ c)
    Rs, ts = np.stack(Rs), np.stack(ts)
    cam_idx = np.repeat(np.arange(n_cams), n_pts)
    pt_idx = np.tile(np.arange(n_pts), n_cams)
    uv, z = project(K[cam_idx], Rs[cam_idx], ts[cam_idx], X[pt_idx])
    assert np.all(z > 0.3)
    uv = uv + noise * rng.randn(*uv.shape)
    prob = NpBAProblem(K=K, cam_idx=cam_idx.astype(np.int32), pt_idx=pt_idx.astype(np.int32),
                       uv=uv, w=np.ones(len(cam_idx)), cam_fixed=np.arange(n_cams) < 2)
    return K, Rs, ts, X, prob


def perturb(rng, Rs, ts, X, cam=0.02, pts=0.05):
    """A start: the free cameras turned by exp(w) and moved by rho on the
    left (w, rho ~ ``cam``), the points moved by ``pts``."""
    xi = rng.randn(Rs.shape[0], 6) * cam
    xi[:2] = 0.0
    dR = rodrigues(xi[:, 3:])
    return (dR @ Rs, np.einsum("nij,nj->ni", dR, ts) + xi[:, :3],
            X + rng.randn(*X.shape) * pts)


def pose_ring(rng, N=12, noise=0.03, loops=((0, -1),)):
    """(R_true, t_true, NpPoseGraph): N-1 odometry edges with twist noise
    ``noise`` and exact loop-closure edges between the node pairs
    ``loops``."""
    Rg = rodrigues(rng.randn(N, 3) * 0.3)
    tg = rng.randn(N, 3)

    def rel(a, b):
        Ra = Rg[a].T
        return Ra @ Rg[b], Ra @ (tg[b] - tg[a])

    ei, ej, Rz, tz = [], [], [], []
    for a in range(N - 1):
        Rr, tr = rel(a, a + 1)
        dR = rodrigues(rng.randn(3) * noise)
        Rz.append(dR @ Rr)
        tz.append(tr + rng.randn(3) * noise)
        ei.append(a)
        ej.append(a + 1)
    for a, b in loops:
        a, b = a % N, b % N
        Rr, tr = rel(a, b)
        Rz.append(Rr)
        tz.append(tr)
        ei.append(a)
        ej.append(b)
    g = NpPoseGraph(i=np.array(ei, np.int32), j=np.array(ej, np.int32), Rz=np.stack(Rz),
                    tz=np.stack(tz), w=np.ones(len(ei)))
    return Rg, tg, g


def chain_start(Rg, tg, g):
    """Integrate the odometry edges from the true first pose (numpy)."""
    N = Rg.shape[0]
    R, t = [Rg[0]], [tg[0]]
    for k in range(N - 1):
        Rk, tk = R[-1], t[-1]
        R.append(Rk @ g.Rz[k])
        t.append(Rk @ g.tz[k] + tk)
    return np.stack(R), np.stack(t)


def rel_err(a, b) -> float:
    """max |a - b| / max |a|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


def np_(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def accept_prefix(costs, cands):
    """The iterations whose accept/reject the two sides must share: from the
    first on, until the first whose candidate cost is within ``DECIDED``
    (relative) of the cost it is compared with.  Past the cost's floor the
    comparison ``new_cost < cost`` reads two costs equal up to rounding, and
    either side may take or refuse a step of the size of rounding."""
    n = 0
    for c, new in zip(costs, cands):
        if abs(new - c) <= DECIDED * abs(c):
            break
        n += 1
    return n
