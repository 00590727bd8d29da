"""The readings the limits of ``correct`` are set from, for one cell, in one
process on the card (set-up is long, so every seed shares it):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--fault half_batch]

For each seed of ``--seeds``, the numbers of a sound run: the program's
first steps (training) or the path's first pass (streaming), through the
timed entry at the cell's sizes, against the reference.  For each of
``--control-seeds``: the control, the reference computed one type below what
the configuration states and put in the program's place, against the
reference.  For each of ``--fault-seeds``: the program with ``--fault``
planted.  One JSON line a reading on standard output.  No measured window:
the readings need none.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from run import fixed_caches  # noqa: E402


def readings(cell, seed: int, kind: str, fault=None, device="cuda") -> dict:
    from benchmark.harness import check, drivers, scene
    from benchmark.reference import neuralrecon as ref

    tr, cfg = cell.traffic, cell.config
    c = ref.resolve(cfg["model_cfgs"])
    V, hw = tr["views"], tuple(tr["image_hw"])
    L = c["n_layers"]
    if tr["driver"] == "train":
        B = cfg["batch"]
        batches = scene.train_pool(seed, tr["check_steps"], B, V, hw, c["n_vox"],
                                   c["voxel_size"], L, device)
        if kind == "control":
            prec = ref.Precision.for_control(cfg["precision"])
            side = drivers.reference_train(cell, seed, batches, None, device, prec=prec)
        else:
            prog = drivers.Program(cell, seed, device, fault)
            state = prog.train_state(B)
            state, side = drivers.program_first_steps(prog, state, batches)
            del state, prog
            drivers.free_device(device)
        refd = drivers.reference_train(cell, seed, batches, side["decisions"], device)
        numbers = check.train_numbers(c, side, refd, B)
        extra = dict(losses=side["losses"], ref_losses=refd["losses"])
    else:
        frags = scene.stream_path(seed, tr["path_fragments"], V, hw, c["n_vox"],
                                  c["voxel_size"], L, tr["scene_m"], tr["spheres"],
                                  tr["path_radius_m"], device)
        if kind == "control":
            prec = ref.Precision.for_control(cfg["precision"])
            ctl = drivers.reference_stream(cell, seed, frags, None, device, prec=prec)
            answers = [{k: v.cpu() for k, v in a.items()} for a in ctl["answers"]]
            decisions = [{k: [t.cpu() for t in v] for k, v in d.items()}
                         for d in ctl["decisions"]]
            hidden = [v.permute(0, 2, 3, 4, 1).cpu() for v in ctl["hidden"]]
            del ctl
        else:
            prog = drivers.Program(cell, seed, device, fault)
            answers, decisions, hidden = drivers.program_pass(prog, frags)
            del prog
        drivers.free_device(device)
        refd = drivers.reference_stream(cell, seed, frags, decisions, device)
        numbers = check.stream_numbers(c, answers, decisions, hidden, refd)
        extra = {}
    drivers.free_device(device)
    return dict(seed=seed, kind=kind if fault is None else fault, numbers=numbers, **extra)


def main(argv=None):
    fixed_caches()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--fault", default="half_batch")
    args = ap.parse_args(argv)
    from benchmark.harness import cells

    cell = cells.load_cell(args.workload)

    def seeds(s):
        return [int(x) for x in s.split(",") if x]
    plan = ([(s, "sound", None) for s in seeds(args.seeds)]
            + [(s, "control", None) for s in seeds(args.control_seeds)]
            + [(s, "fault", args.fault) for s in seeds(args.fault_seeds)])
    for seed, kind, fault in plan:
        t = time.perf_counter()
        r = readings(cell, seed, kind, fault)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    print(f"calibrate: {len(plan)} readings in {time.perf_counter() - T0:.1f} s",
          file=sys.stderr)


if __name__ == "__main__":
    main()
