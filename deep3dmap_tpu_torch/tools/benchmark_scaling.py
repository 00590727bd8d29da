#!/usr/bin/env python
"""Data-parallel scaling report for NeuralRecon training (port of
``tools/benchmark_scaling.py``).

For each rank count it spawns that many processes, one rank each, and runs
the data-parallel training step (``runners/train_state.py``: the fused
loss's sums and the gradients summed over the ranks) on ONE fixed global
batch, each rank on its share; it reports the per-step losses against the
1-rank run's on the same batch, the collectives one step issues (calls by
kind, counted in ``parallel/collectives.py``, in place of the JAX tool's
HLO counts) and the time per step.

On the CPU (``--device cpu``) the ranks are gloo processes sharing the
host's cores.  On cards, rank r runs on ``cuda:r`` over NCCL when the host
has a card for every rank; with fewer cards than ranks they share
``cuda:0`` over gloo, whose collectives copy through pinned host memory
(``parallel/collectives.py``).  Each row names its ``route``.  Only the
NCCL route, one card a rank, makes ``step_ms`` a scaling measure; on the
shared routes what the report certifies is that the sharded step runs at
every rank count and reproduces the 1-rank losses (``equivalent``: JAX's
rule, the first step within 1e-3 relative, the later ones within 5e-2).

Usage:
    python -m deep3dmap_tpu_torch.tools.benchmark_scaling [--devices 1 2 4 8]
        [--modes dense block] [--n-vox 24] [--img 48] [--views 4] [--iters 3]
        [--device cuda|cpu] [--out FILE]
"""
import argparse
import json
import os
import os.path as osp
import subprocess
import sys
import tempfile
import time

if __package__ in (None, ""):
    sys.path.insert(0, osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))))

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8],
                   help="rank counts")
    p.add_argument("--n-vox", type=int, default=24)
    p.add_argument("--img", type=int, default=48)
    p.add_argument("--views", type=int, default=4)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--global-batch", type=int, default=None,
                   help="fixed global batch for all rank counts (default: max(devices))")
    p.add_argument("--modes", nargs="+", default=["dense", "block"],
                   choices=["dense", "block"])
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--timeout", type=float, default=600,
                   help="seconds for each rank group")
    p.add_argument("--out", default=None, help="write the report json here")
    # a rank of a group (set by the launcher, not by hand)
    p.add_argument("--rank-of", nargs=4, metavar=("RANK", "WORLD", "INIT", "WORK"),
                   default=None, help=argparse.SUPPRESS)
    p.add_argument("--mode", default="dense", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def model_cfg(mode: str, n_vox: int) -> dict:
    """The JAX tool's model: dense, or block levels in bf16."""
    cfg = dict(N_LAYER=3, N_VOX=[n_vox] * 3, VOXEL_SIZE=0.08,
               FUSION=dict(FUSION_ON=True, FULL=True),
               BACKBONE2D=dict(ARC="fpn-mnas-0.5"))
    if mode == "block":
        # every block level (n_vox and n_vox/2) must divide by the block side
        bs = 8 if n_vox % 16 == 0 else 4
        nb_mid, nb_fine = (n_vox // 2) // bs, n_vox // bs
        cfg.update(SPARSE_MODE="block", BLOCK_SIZE=bs,
                   MAX_BLOCKS=[None, max(nb_mid ** 3 // 2, 2), max(nb_fine ** 3 // 4, 4)],
                   GLOBAL_DTYPE="bfloat16", BLOCK_DTYPE="bfloat16")
    return cfg


def rank_route(device, rank: int, world: int):
    """(device, backend, route) of rank ``rank`` of ``world``: a card of its
    own over NCCL where the host has one for every rank, else ``cuda:0``
    shared over gloo; gloo on the CPU."""
    import torch

    if device.type != "cuda":
        return device, "gloo", "gloo, CPU"
    if torch.cuda.device_count() >= world:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        return device, "nccl", "nccl, one card a rank"
    torch.cuda.set_device(0)
    return (torch.device("cuda", 0), "gloo",
            f"gloo staged through host memory, {world} ranks sharing cuda:0")


def run_rank(args):
    """One rank: the data-parallel step on this rank's share of the global
    batch, ``1 + iters`` times; rank 0 writes the losses, the collectives
    of a step and the median time per timed step."""
    import torch
    import torch.distributed as dist

    from deep3dmap_tpu_torch.models.frameworks.neuralrecon import NeuralRecon
    from deep3dmap_tpu_torch.parallel import collectives, make_mesh, replicate, shard_batch
    from deep3dmap_tpu_torch.runners.optim import build_optimizer
    from deep3dmap_tpu_torch.runners.train_state import TrainState, train_step
    from deep3dmap_tpu_torch.utils.device import make_deterministic, resolve_device

    rank, world, init, work = args.rank_of
    rank, world = int(rank), int(world)
    device, backend, route = rank_route(resolve_device(args.device), rank, world)
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
    try:
        make_deterministic()
        batch = torch.load(osp.join(work, "batch.pt"), map_location=device,
                           weights_only=False)
        fw = NeuralRecon(model_cfg(args.mode, args.n_vox), device=device)
        mesh = make_mesh(("data",), device=device)
        fw.set_mesh(mesh)
        local = shard_batch(batch, mesh, global_batch=True)
        net, model_state = fw.init(0, local)
        replicate(net, mesh)
        state = TrainState(net=net, model_state=model_state,
                           optimizer=build_optimizer(dict(type="Adam", lr=1e-3),
                                                     net.parameters()))
        losses, times, counts = [], [], {}
        for it in range(1 + args.iters):
            collectives.reset_counts()
            t0 = time.perf_counter()
            state, logs = train_step(fw, state, local)
            losses.append(float(logs["loss"]))       # waits for the step
            times.append((time.perf_counter() - t0) * 1e3)
            counts = collectives.counts()
        if rank == 0:
            timed = sorted(times[1:]) or times
            with open(osp.join(work, "result.json"), "w") as f:
                json.dump(dict(losses=losses, collectives=counts, backend=backend,
                               route=route, step_ms=timed[len(timed) // 2]), f)
    finally:
        dist.destroy_process_group()


def bench_n(n, mode, args, work) -> dict:
    """Spawn ``n`` ranks on the batch in ``work``; rank 0's result."""
    init = "file://" + osp.join(work, f"store_{mode}_{n}")
    cmd = [sys.executable, "-m", "deep3dmap_tpu_torch.tools.benchmark_scaling",
           "--mode", mode, "--n-vox", str(args.n_vox), "--iters", str(args.iters)]
    if args.device:
        cmd += ["--device", args.device]
    env = dict(os.environ, OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"),
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(cmd + ["--rank-of", str(r), str(n), init, work], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    errs = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=args.timeout)
            if p.returncode:
                errs.append(f"rank {r} of {n} exited {p.returncode}: {err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if errs:
        raise RuntimeError("\n".join(errs))
    with open(osp.join(work, "result.json")) as f:
        res = json.load(f)
    os.remove(osp.join(work, "result.json"))
    return res


def main(argv=None):
    args = parse_args(argv)
    if args.rank_of is not None:
        return run_rank(args)
    import numpy as np
    import torch

    from deep3dmap_tpu_torch.datasets.builder import _stack_samples
    from deep3dmap_tpu_torch.datasets.synthetic import make_fragment_sample
    from deep3dmap_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    gb = args.global_batch or max(args.devices)
    samples = [make_fragment_sample(seed=i, n_views=args.views, img_size=(args.img, args.img),
                                    n_vox=args.n_vox, voxel_size=0.08, device=device)
               for i in range(gb)]
    batch = _stack_samples(samples)
    report = {}
    with tempfile.TemporaryDirectory(prefix="scaling_") as work:
        torch.save(batch, osp.join(work, "batch.pt"))
        for mode in args.modes:
            rows, ref = [], None
            for n in args.devices:
                if gb % n:
                    continue
                res = bench_n(n, mode, args, work)
                losses = res["losses"]
                ref = losses if ref is None else ref
                la, lr = np.array(losses), np.array(ref)
                rel0 = float(abs(la[0] - lr[0]) / abs(lr[0]))
                rel = float(np.max(np.abs(la - lr) / np.abs(lr)))
                row = dict(devices=n, backend=res["backend"], route=res["route"],
                           losses=losses,
                           first_step_rel_drift_vs_1dev=rel0,
                           max_rel_loss_drift_vs_1dev=rel,
                           max_abs_loss_drift_vs_1dev=float(np.max(np.abs(la - lr))),
                           equivalent=bool(rel0 < 1e-3 and rel < 0.05),
                           collectives=res["collectives"], step_ms=res["step_ms"])
                rows.append(row)
                print(json.dumps(dict(mode=mode, **row)), flush=True)
            report[mode] = rows
    out = {"report": "neuralrecon_train_scaling", "global_batch": gb, "modes": report,
           "n_vox": args.n_vox, "views": args.views,
           "platform": "gpu" if device.type == "cuda" else "cpu",
           "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                      else "cpu"),
           "all_equivalent": bool(all(r["equivalent"] for rows in report.values()
                                      for r in rows)),
           "note": ("step_ms measures scaling only on rows whose route is 'nccl, one "
                    "card a rank'; on the other routes the ranks share one device (the "
                    "host's cores, or cuda:0 over gloo), and what a row certifies is that "
                    "the data-parallel step runs at that rank count, issues the listed "
                    "collectives a step, and reproduces the 1-rank losses on the same "
                    "global batch")}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
