#!/usr/bin/env python
"""BA iterations per second (port of ``tools/benchmark_ba.py``).

Times the Schur-complement LM bundle adjuster (``core/sfm/ba.py``) on a
synthetic fragment-scale problem: each point seen by ``--obs-per-pt``
consecutive cameras on an arc, 0.5 px of noise, the first two cameras
fixed, a perturbed start.  The problem is the JAX tool's, drawn from
``numpy.random.RandomState(0)`` in the same order and built in float32 as
the JAX tool builds it.  The solve runs on the card by default (``--device
cuda``; it raises without a GPU), timed with CUDA events after a warm-up,
the best of ``--reps``; ``--device cpu`` times it on the host's clock.

Prints one JSON line with the JAX tool's fields (``device`` names the card)
and the card's ``power_limit_w``.  Started by ``torchrun`` on more than one
rank (``--nproc_per_node N``: one card each, NCCL; with ``--device cpu``
gloo), it also times ``lm_solve_sharded`` with the observations split over
the ranks and adds the JAX tool's ``sharded_devices`` and
``sharded_lm_iters_per_s``; rank 0 prints.

Usage: python -m deep3dmap_tpu_torch.tools.benchmark_ba [--cams 24]
    [--pts 4096] [--obs-per-pt 8] [--iters 30] [--reps 3] [--device cuda]
"""
import argparse
import json
import os.path as osp
import subprocess
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))))

import numpy as np
import torch

from deep3dmap_tpu_torch.core import sfm
from deep3dmap_tpu_torch.core.sfm.ba import BAProblem
from deep3dmap_tpu_torch.utils.device import resolve_device
from deep3dmap_tpu_torch.utils.from_flax import from_jax_tuple


def make_problem(rng, n_cams, n_pts, obs_per_pt, device=None):
    """(K, Rs, ts, X, BAProblem) in float32 on ``device`` (``None``: the
    card), the JAX tool's problem: its draws from ``rng`` in its order, the
    rotations and projections in float32 as JAX computes them by default."""
    if not 1 <= obs_per_pt <= n_cams:
        # JAX's tool gathers the cameras past the last clamped and drops
        # their normal-equation rows: a problem other than the one described
        raise ValueError(f"make_problem: each point is seen by {obs_per_pt} consecutive "
                         f"cameras, which needs 1 <= obs_per_pt <= n_cams ({n_cams})")
    dev = resolve_device(device)
    f32 = np.float32
    X = rng.randn(n_pts, 3).astype(np.float64) * 0.6
    K = np.tile(np.array([320.0, 320.0, 160.0, 120.0]), (n_cams, 1))
    Rs, ts = [], []
    for i in range(n_cams):
        ang = 0.5 * i / max(n_cams - 1, 1)
        R = sfm.so3_exp(torch.tensor([0.0, ang, 0.0], dtype=torch.float32)).numpy()
        c = np.array([2.5 * np.sin(ang), 0.02 * i, -2.5 * np.cos(ang)])
        Rs.append(R)
        ts.append(-R @ c)
    Rs, ts = np.stack(Rs), np.stack(ts)
    # each point observed by obs_per_pt consecutive cameras
    pt_idx = np.repeat(np.arange(n_pts), obs_per_pt)
    start = rng.randint(0, max(n_cams - obs_per_pt, 1), n_pts)
    cam_idx = (start[:, None] + np.arange(obs_per_pt)[None]).reshape(-1)
    uv, _ = sfm.project(*(torch.from_numpy(a.astype(f32)) for a in (
        K[cam_idx], Rs[cam_idx], ts[cam_idx], X[pt_idx])))
    uv = uv.numpy() + 0.5 * rng.randn(*uv.shape)
    prob = BAProblem(K=K.astype(f32), cam_idx=cam_idx, pt_idx=pt_idx, uv=uv.astype(f32),
                     w=np.ones(len(cam_idx), f32), cam_fixed=np.arange(n_cams) < 2)
    return (*(torch.from_numpy(a.astype(f32)).to(dev) for a in (K, Rs, ts, X)),
            from_jax_tuple(BAProblem, prob, device=dev))


def perturbed_start(rng, Rs, ts, X):
    """The JAX tool's start: camera twists of 0.01 (the fixed two at 0) and
    0.03 on the points, drawn after the problem, in float32."""
    dxi = rng.randn(Rs.shape[0], 6) * 0.01
    dxi[:2] = 0.0
    R0, t0 = sfm.se3_retract(Rs, ts, torch.from_numpy(dxi.astype(np.float32)).to(Rs.device))
    X0 = X + torch.from_numpy((rng.randn(*X.shape) * 0.03).astype(np.float32)).to(X.device)
    return R0, t0, X0


def power_limit_w(device: torch.device):
    """The card's power limit in W from ``nvidia-smi``; None off the card."""
    if device.type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                          "-i", str(device.index or 0)],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0])


def time_solve(run, device: torch.device, reps: int):
    """(best seconds of ``reps`` calls after a warm-up, the last result):
    CUDA events on the card, the host's clock on the CPU."""
    res = run()
    best = float("inf")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(reps):
            start.record()
            res = run()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            res = run()
            best = min(best, time.perf_counter() - t0)
    return best, res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cams", type=int, default=24)
    ap.add_argument("--pts", type=int, default=4096)
    ap.add_argument("--obs-per-pt", type=int, default=8)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    from deep3dmap_tpu_torch.parallel.mesh import get_dist_info, init_dist, make_mesh

    init_dist(device=args.device)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    rank, world = get_dist_info()

    rng = np.random.RandomState(0)
    K, Rs, ts, X, prob = make_problem(rng, args.cams, args.pts, args.obs_per_pt,
                                      device=device)
    R0, t0, X0 = perturbed_start(rng, Rs, ts, X)
    t_best, res = time_solve(lambda: sfm.lm_solve(R0, t0, X0, prob, iters=args.iters),
                             device, args.reps)
    iters_per_s = args.iters / t_best
    M = int(prob.uv.shape[0])
    out = {
        "report": "ba_lm_schur",
        "cams": args.cams, "points": args.pts,
        "observations": M,
        "lm_iters_per_s": round(iters_per_s, 2),
        "obs_per_s": round(iters_per_s * M, 1),
        "initial_cost": float(res.initial_cost), "final_cost": float(res.cost),
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else device.type),
        "power_limit_w": power_limit_w(device),
    }
    if world > 1:
        mesh = make_mesh(("data",), device=device)
        dt, _ = time_solve(lambda: sfm.lm_solve_sharded(mesh, R0, t0, X0, prob,
                                                        iters=args.iters),
                           device, args.reps)
        out["sharded_devices"] = world
        out["sharded_lm_iters_per_s"] = round(args.iters / dt, 2)
    if rank == 0:
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
