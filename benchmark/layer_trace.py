"""A training cell's traced steps put down to the program's layers.

    python3 benchmark/layer_trace.py --workload nr_block.train --seed N \
        [--warm 5] [--steps 2]

Builds the cell as ``run.py`` does (the program, its weights and the pool of
scenes from the seed), takes ``--warm`` steps, then traces ``--steps`` steps
under ``torch.profiler`` inside the benchmark's window span
(``harness/layers.py``) and prints one JSON line: per program span and step
the calls, host ms, forward and backward kernels and device ms and the
device's idle ms (``layers``), the program's counters over the traced steps
(``counters``), the host's waits by span (``host_waits``), the shares of
device and idle time the spans account for (``shares``), and the idle time
by innermost host op as ``run.py``'s breakdown names it (``idle_gaps``).
"""
import argparse
import json
import sys

import run


def main(argv=None):
    run.fixed_caches()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--warm", type=int, default=5)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cells, drivers, layers, scene

    cell = cells.load_cell(args.workload)
    if cell.traffic["driver"] != "train":
        print(f"layer_trace.py: {args.workload} is not a training cell", file=sys.stderr)
        return 2
    tr, cfg = cell.traffic, cell.config
    B, V, hw = cfg["batch"], tr["views"], tuple(tr["image_hw"])
    n_vox, vs, L = drivers._levels(cfg)
    prog = drivers.Program(cell, args.seed, args.device)
    pool = scene.train_pool(args.seed, tr["pool_fragments"] // B, B, V, hw, n_vox, vs, L,
                            args.device)
    box = [prog.train_state(B)]
    for k in range(args.warm):
        box[0], _ = prog.step(box[0], pool[k % len(pool)])
    drivers._settle(args.device)
    try:
        from deep3dmap_tpu_torch.utils import tracing
    except ImportError:          # a program without spans or counters
        tracing = None
    if tracing is not None:
        tracing.reset_counters()        # every counter covers the traced steps alone

    def steps():
        for j in range(args.steps):
            box[0], _ = prog.step(box[0], pool[(args.warm + j) % len(pool)])
        drivers._sync(args.device)
    out = layers.profile_layers(steps, args.steps)
    out["counters"] = tracing.read_counters() if tracing is not None else {}
    out["workload"], out["seed"], out["device"] = args.workload, args.seed, (
        torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu")
    print(json.dumps(out, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
