"""Run one cell of the benchmark on this machine's cards.

    python3 benchmark/run.py --workload <config>.<traffic> --seed N \
        --seconds S --trace 0|1

Prints the run's numbers to standard error and, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device``, ``breakdown`` (traced
runs) and ``checks``, each number of the correctness check beside its limit.

Exits 2 without a result when there is no CUDA card or fewer cards than the
cell asks for, and 3 when JAX or the JAX package was loaded.  Compile caches
(Triton's, torch extensions') live in ``benchmark/.cache/``.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)

FORBIDDEN = ("jax", "jaxlib", "flax", "deep3dmap_tpu")


def loaded_forbidden():
    """Top-level names (whole, before the first dot) of loaded modules that
    belong to JAX or the JAX package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def host_lines():
    """The host's CPU model and this process's CPU affinity, the card's
    clocks and power limit (host-paced numbers differ between hosts)."""
    out = []
    try:
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name")),
                         "unknown")
        out.append(f"host cpu: {model}; affinity {len(os.sched_getaffinity(0))} cores")
    except OSError:
        pass
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        out.append(f"card: {q.stdout.strip()}")
    except (OSError, subprocess.SubprocessError):
        pass
    return out


def fixed_caches() -> None:
    """The program's compile caches at fixed paths inside the checkout, set
    before anything imports Triton; the checkout's root on the path."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(BENCH, ".cache", sub)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def main(argv=None):
    fixed_caches()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import cells, drivers

    cell = cells.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: {args.workload} needs {cell.chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    for line in host_lines():
        print(line, file=sys.stderr, flush=True)
    out = drivers.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    bad = loaded_forbidden()
    if bad:
        print(f"run.py: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    res = out["result"]
    print("run: " + json.dumps(out["info"], default=float), file=sys.stderr)
    for name, m in res["metrics"].items():
        print(f"metric {name} = {m['value']!r} {m['unit']}", file=sys.stderr)
    print(f"correct = {res['correct']} (attempted {res['attempted']}, failed {res['failed']})",
          file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
