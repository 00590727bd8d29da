#!/usr/bin/env python3
"""Device time of the fused loss's backward on one CUDA card: this tree's
``loss_bwd_kernel`` at a few tile shapes, beside a parent tree's backward on
the same inputs.

    python3 tools/ab_loss_bwd.py [--check] [--parent DIR]

Inputs: ``chip_smoke.loss_inputs`` at NeuralRecon's three level sizes (24³,
48³, 96³) with float32 predictions and targets, once with the bool mask
``loss_fn`` hands over and once with a float32 mask, on cold copies
(``chip_smoke.cold_copies``), the L2 flushed before each call
(``chip_smoke.l2_flushed``).  Each variant (elements per program, warps) is
timed as one launch over the three levels and on the 96³ level alone, with
``chip_smoke.device_ms`` (torch.profiler, median of 3 windows), beside
``chip_smoke.loss_bwd_bound_ms`` summed over the levels.  ``--parent DIR``
loads ``DIR/deep3dmap_tpu_torch/ops/fused_loss.py`` (a checkout of an earlier
commit, e.g. unpacked with ``git archive``) and times its backward on the
same inputs, one call per level; the parent runs first and last, the
variants in between in both orders.  ``--check`` first runs
``chip_smoke.py``'s phase 8 (kernel against plain).  For each variant it
prints the kernel's registers and spills and what the compiled kernel holds
(layout conversions in the TTGIR, vector loads and streaming stores in the
PTX).  Imports no JAX.
"""
import argparse
import importlib.util
import os
import re
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs                                   # noqa: E402
from deep3dmap_tpu_torch.ops import fused_loss            # noqa: E402

SIDES = (24, 48, 96)
VARIANTS = "512x4,1024x8,1024x4,2048x8,4096x8"   # elements a program x warps
LW = ((1.0, 0.0, 0.0), (0.8, 0.0, 0.0), (0.64, 0.0, 0.0))   # loss_fn's cotangents


def _record_compiled():
    """Wrap the backward kernel so every launch keeps its compiled kernel,
    by (BLOCK, num_warps)."""
    triton, loss_kernel, bwd = fused_loss._kernel()
    compiled = {}

    class Recording:
        def __getitem__(self, grid):
            launch = bwd[grid]

            def run(*a, **kw):
                k = launch(*a, **kw)
                compiled.setdefault((kw["BLOCK"], kw["num_warps"]), k)
                return k
            return run
    fused_loss._kernel = lambda: (triton, loss_kernel, Recording())
    return compiled


PTX_COUNTS = {"ptx_ld_global": r"ld\.global",
              "ptx_ld_global_v4": r"ld\.global[^;]*\.v4",
              "ptx_ld_evict_first": r"ld\.global[^;]*evict_first",
              "ptx_st_global_cs": r"st\.global\.cs"}


def _describe(k) -> str:
    asm = getattr(k, "asm", {}) or {}
    ttgir, ptx = asm.get("ttgir", ""), asm.get("ptx", "")
    counts = {"ttgir_convert_layout": ttgir.count("convert_layout"),
              "ttgir_local_alloc": ttgir.count("local_alloc")}
    counts.update({k2: len(re.findall(pat, ptx)) for k2, pat in PTX_COUNTS.items()})
    return (f"regs={getattr(k, 'n_regs', None)} spills={getattr(k, 'n_spills', None)} "
            + " ".join(f"{k2}={v}" for k2, v in counts.items()))


def _parent_module(parent_dir):
    path = os.path.join(parent_dir, "deep3dmap_tpu_torch", "ops", "fused_loss.py")
    spec = importlib.util.spec_from_file_location("parent_fused_loss", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _time_parent(parent, levels) -> float:
    """The parent's backward: one call per level, each with its own sums."""
    outs = [parent.fused_tsdf_occ_loss_cuda(*lv, pos_weight=1.5) for lv in levels]
    gs = [torch.tensor(g, device="cuda") for g in LW[-len(levels):]]
    sets = cs.cold_copies(tuple(a for lv in levels for a in lv) + tuple(outs) + tuple(gs))
    n = len(levels)

    def run(*a):
        for i in range(n):
            parent.fused_tsdf_occ_loss_bwd_cuda(*a[5 * i:5 * i + 5], a[5 * n + i],
                                                a[6 * n + i], 1.5)
    return cs.device_ms(cs.l2_flushed(run), sets, names=cs.BWD_STAGES)


def _time_variant(levels, block, warps) -> float:
    fused_loss._BWD_BLOCK, fused_loss._BWD_WARPS = block, warps
    g = torch.tensor(LW[-len(levels):], device="cuda")
    return cs.time_loss_bwd(fused_loss, levels, g)["ms"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of an earlier checkout to time beside")
    ap.add_argument("--check", action="store_true",
                    help="run chip_smoke.py's phase 8 (kernel vs plain) first")
    ap.add_argument("--variants", default=VARIANTS,
                    help=f"tile shapes, elements a program x warps (default {VARIANTS})")
    args = ap.parse_args()
    variants = [tuple(int(v) for v in x.split("x")) for x in args.variants.split(",")]
    if not torch.cuda.is_available():
        sys.exit("ab_loss_bwd: needs a CUDA GPU")
    card = cs.device_line()
    print(card, flush=True)
    default = (fused_loss._BWD_BLOCK, fused_loss._BWD_WARPS)
    if args.check:
        cs.phase_loss_bwd(fused_loss)
    compiled = _record_compiled()
    gen = torch.Generator(device="cuda").manual_seed(2)
    sets = {"bool_mask": [cs.loss_inputs(gen, (1, d, d, d)) for d in SIDES]}
    sets["f32_mask"] = [lv[:4] + (lv[4].float(),) for lv in sets["bool_mask"]]
    parent = _parent_module(args.parent) if args.parent else None
    for name, levels in sets.items():
        bound = sum(cs.loss_bwd_bound_ms(lv) for lv in levels)
        bound96 = cs.loss_bwd_bound_ms(levels[-1])
        print(f"inputs {name}: dtypes={cs._dtypes(levels[0])} bound_ms_per_step="
              f"{bound:.6f} bound_ms_96^3={bound96:.6f}", flush=True)
        order = variants + variants[::-1]
        res = {}
        if parent:
            res.setdefault("parent", []).append(
                (_time_parent(parent, levels), _time_parent(parent, levels[-1:])))
        for block, warps in order:
            res.setdefault(f"block{block}_warps{warps}", []).append(
                (_time_variant(levels, block, warps),
                 _time_variant(levels[-1:], block, warps)))
        if parent:
            res["parent"].append((_time_parent(parent, levels),
                                  _time_parent(parent, levels[-1:])))
        for key, runs in res.items():
            step = [r[0] for r in runs]
            lone = [r[1] for r in runs]
            print(f"{name} {key}: ms_per_step={step} "
                  f"bound_share={bound / min(step):.6f} ms_96^3="
                  f"{lone} bound_share_96^3="
                  f"{bound96 / min(lone):.6f}", flush=True)
    fused_loss._BWD_BLOCK, fused_loss._BWD_WARPS = default
    for (block, warps), k in sorted(compiled.items()):
        print(f"compiled block{block}_warps{warps}: {_describe(k)}", flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
