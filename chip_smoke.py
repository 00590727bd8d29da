#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``deep3dmap_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # the check: needs one CUDA card
    python3 chip_smoke.py --profile DIR    # also a torch.profiler pass at full
                                           # width, its tables into DIR

Phases; any error ends the run with a nonzero exit and no result line:

1. device: the card's name and power limit (``nvidia-smi``).
2. kernel vs plain: the fused TSDF/occupancy loss (Triton) against its plain
   PyTorch version on the card, at the three level sizes of the bench
   pyramid (1x24³, 1x48³, 1x96³, the dtypes ``val_fn`` gives it), a ragged
   size, an empty target, an all-zero mask and bf16 predictions.  Device
   time of the kernels (torch.profiler, inputs cold in the L2) and the time
   of one call with its host launch cost (CUDA events), beside the
   memory-rate bound.
3. CPU vs card: the small block config at float32 with TF32 off, same
   seeded weights, ``forward_test`` over 2 fragments with carried state and
   ``val_fn`` on the CPU and on the card; identical block ids.
4. full width: the ``bench.py`` NeuralRecon config (9 views at 480x640, 96³,
   block-sparse levels, bf16) with seeded weights; 2 warm-up plus 10 timed
   fragments through ``forward_test`` with carried state, then ``val_fn``,
   whose loss must launch the kernel exactly 3 times.

Before the last line it prints one ``{"kernels": [...]}`` line; the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
# fused loss, per element: 5 loads converted, softplus (abs, neg, exp, add,
# log), two slogs (sign 4, abs, add, log, mul each), five masked accumulates
LOSS_OPS_PER_ELEM = 45

TOL_LOSS = dict(rtol=1e-4, atol=1e-6)   # kernel vs plain: f32 sums, other order
TOL_SLICE = 2e-3                        # CPU vs card, float32 (see phase 3)
TOL_VAL_RTOL = 1e-4

BLOCK_CFGS = dict(N_LAYER=3, N_VOX=[32, 32, 32], VOXEL_SIZE=0.08,
                  TRAIN_NUM_SAMPLE=[64, 256],
                  FUSION=dict(FUSION_ON=True, FULL=True), LW=[1.0, 0.8, 0.64],
                  THRESHOLDS=[0, 0, 0], POS_WEIGHT=1.5,
                  BACKBONE2D=dict(ARC="fpn-mnas-0.5"), SPARSE_MODE="block",
                  BLOCK_SIZE=8, MAX_BLOCKS=[None, 4, 24])

# bench.py:159-179, the production fragment shape
BENCH_CFGS = dict(
    N_LAYER=3, N_VOX=[96, 96, 96], VOXEL_SIZE=0.04,
    TRAIN_NUM_SAMPLE=[4096, 16384, 65536],
    FUSION=dict(FUSION_ON=True, FULL=True), LW=[1.0, 0.8, 0.64],
    THRESHOLDS=[0, 0, 0], POS_WEIGHT=1.5, SPARSE_MODE="block", BLOCK_SIZE=8,
    GLOBAL_DTYPE="bfloat16", BLOCK_DTYPE="bfloat16",
    BACKBONE2D=dict(ARC="fpn-mnas-1", DTYPE="bfloat16", MODE="batch",
                    REMAT=False, INFER_MODE="batch"))
N_VIEWS, IMG_HW, N_VOX = 9, (480, 640), 96
WARMUP, TIMED = 2, 10


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def phase(name: str):
    print(f"== {name}", flush=True)


def set_tf32(cudnn: bool, matmul: bool):
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul
    print(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


# ---------------------------------------------------------------- phase 1 --
def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed nothing")
    return out[0].strip()


# ---------------------------------------------------------------- phase 2 --
L2_BYTES = 50e6
TRITON_STAGES = ("sums_kernel", "final_kernel")   # ops/fused_loss.py


def device_kernels(prof, names=None):
    """The CUDA kernels of a torch.profiler profile (averaged by name),
    without the device-side copies of ``span:`` ranges; only those whose
    name holds one of ``names`` when given."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.key.startswith("span:")
            and (names is None or any(n in e.key for n in names))]


def kernel_us(prof, names=None) -> float:
    """Summed device time of those kernels, µs."""
    return sum(e.self_device_time_total for e in device_kernels(prof, names))


def cold_copies(args):
    """Copies of one input set that together exceed the L2 twice (at most
    64), so a call that cycles over them finds its inputs cold, as
    ``val_fn``'s loss finds the batch's targets."""
    nbytes = sum(a.numel() * a.element_size() for a in args)
    n = int(min(64, max(2, -(-2 * L2_BYTES // nbytes))))
    return [tuple(a.clone() for a in args) for _ in range(n)]


def device_ms(fn, arg_sets, names=None, reps: int = 64) -> float:
    """Device time of one call: the CUDA kernels (those named by ``names``,
    or all) that ``reps`` calls launch, summed by torch.profiler, over
    ``reps``."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for r in range(reps):
            fn(*arg_sets[r % len(arg_sets)])
        torch.cuda.synchronize()
    return kernel_us(prof, names) / reps / 1e3


def call_ms(fn, arg_sets, reps: int = 64) -> float:
    """Median time of one call as its caller sees it, host launch cost
    included: CUDA events around each call, synchronised after each."""
    times = []
    for r in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*arg_sets[r % len(arg_sets)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def loss_inputs(gen, shape, pred_dtype=torch.float32, target_dtype=torch.float32,
                empty_target=False, zero_mask=False):
    dev = "cuda"

    def u(lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo
    tsdf = u(-1, 1).to(pred_dtype)
    occ = torch.randn(shape, generator=gen, device=dev).to(pred_dtype)
    tsdf_t = u(-1, 1)
    occ_t = u(0, 1) > 0.7
    if empty_target:
        occ_t = torch.zeros_like(occ_t)
    mask = u(0, 1) > 0.3
    if zero_mask:
        mask = torch.zeros_like(mask)
    return tsdf, occ, tsdf_t, occ_t.to(target_dtype), mask


def loss_bound_ms(args) -> float:
    n = args[0].numel()
    nbytes = sum(a.numel() * a.element_size() for a in args) + 5 * 4
    return max(nbytes / HBM_BYTES_PER_S, n * LOSS_OPS_PER_ELEM / F32_OPS_PER_S) * 1e3


def phase_kernel_vs_plain(fused_loss):
    phase("kernel vs plain: fused_tsdf_occ_loss (Triton) vs plain PyTorch")
    set_tf32(cudnn=False, matmul=False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, b = torch.bfloat16, torch.bool
    cases = [(f"level{i}_{d}^3", (1, d, d, d), dict()) for i, d in
             enumerate((24, 48, 96))]
    cases += [("ragged_1000003_bf16", (1000003,),
               dict(pred_dtype=bf16, target_dtype=b)),
              ("empty_target_48^3", (1, 48, 48, 48), dict(empty_target=True)),
              ("zero_mask_48^3", (1, 48, 48, 48), dict(zero_mask=True)),
              ("bf16_pred_96^3", (1, 96, 96, 96),
               dict(pred_dtype=bf16, target_dtype=b))]
    max_err = 0.0
    timed = {}
    for name, shape, kw in cases:
        args = loss_inputs(gen, shape, **kw)
        before = fused_loss.launches
        got = torch.stack(fused_loss.fused_tsdf_occ_loss(*args, pos_weight=1.5))
        again = torch.stack(fused_loss.fused_tsdf_occ_loss(*args, pos_weight=1.5))
        want = torch.stack(fused_loss.fused_tsdf_occ_loss_plain(*args,
                                                                pos_weight=1.5))
        torch.cuda.synchronize()
        check(fused_loss.launches == before + 2,
              f"{name}: the wrapper did not launch the kernel")
        check(torch.isfinite(got).all().item(), f"{name}: non-finite loss {got}")
        check(torch.equal(got, again), f"{name}: two runs differ: {got} {again}")
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, **TOL_LOSS),
              f"{name}: kernel {got.tolist()} vs plain {want.tolist()}")
        if "empty_target" in name or "zero_mask" in name:
            check(got[0].item() == 0.0, f"{name}: total loss should be 0")
        max_err = max(max_err, err)
        line = (f"fused_loss {name}: n={args[0].numel()} dtypes="
                f"{[str(a.dtype).replace('torch.', '') for a in args]} "
                f"kernel={got.tolist()} plain={want.tolist()} abs_err={err:.3g}")
        if name.startswith("level"):
            sets = cold_copies(args)

            def kern(*a):
                return fused_loss.fused_tsdf_occ_loss(*a, pos_weight=1.5)

            def plain(*a):
                return fused_loss.fused_tsdf_occ_loss_plain(*a, pos_weight=1.5)
            # ms / plain_ms: the five sums alone (the two Triton stages; the
            # plain version's partial_sums_plain); wrapper_*: with _combine
            t = dict(ms=device_ms(kern, sets, names=TRITON_STAGES),
                     plain_ms=device_ms(fused_loss.partial_sums_plain, sets),
                     bound_ms=loss_bound_ms(args),
                     wrapper_ms=device_ms(kern, sets),
                     plain_wrapper_ms=device_ms(plain, sets),
                     call_ms=call_ms(kern, sets),
                     plain_call_ms=call_ms(plain, sets))
            for k, v in t.items():
                timed[k] = timed.get(k, 0.0) + v
            line += " " + " ".join(f"{k}={v:.6f}" for k, v in t.items())
            line += f" input_copies={len(sets)}"
        print(line, flush=True)
    print("fused_loss per val_fn (3 levels): " + " ".join(
        f"{k}={v:.6f}" for k, v in timed.items()) + " (ms, plain_ms: device "
          "time of the five sums; wrapper_ms, plain_wrapper_ms: device time "
          "of the whole loss; call_ms: one call with its host launch cost; "
          f"bound: bytes over {HBM_BYTES_PER_S / 1e12} TB/s)", flush=True)
    return dict(timed, max_abs_err=max_err)


# ---------------------------------------------------------------- phase 3 --
def _record_block_ids(nr_module):
    """Wrap the framework's ``select_blocks`` so every chosen block set is
    kept; returns (ids list, restore function)."""
    ids, orig = [], nr_module.select_blocks

    def rec(*a, **kw):
        bset = orig(*a, **kw)
        ids.append(bset.ids.cpu())
        return bset
    nr_module.select_blocks = rec

    def restore():
        nr_module.select_blocks = orig
    return ids, restore


def _stream(nr_module, fw, frags):
    ids, restore = _record_block_ids(nr_module)
    net = fw.net
    o1, m1 = fw.forward_test(net, fw.init_state(2), frags[0])
    o2, m2 = fw.forward_test(net, m1, frags[1])
    val = fw.val_fn(net, m1, frags[1])["log_vars"]["loss"]
    restore()
    host = lambda t: t.float().cpu()   # noqa: E731
    return dict(o1={k: host(v) for k, v in o1.items()},
                o2={k: host(v) for k, v in o2.items()},
                hidden=[host(v) for v in m2["global_hidden"].volumes],
                val=float(val), ids=ids)


def phase_cpu_vs_card(nr_module, stack, make_sample):
    phase("CPU vs card: small block config, float32, 2 fragments + val_fn")
    set_tf32(cudnn=False, matmul=False)
    frags = []
    for k, pair in enumerate(((0, 1), (2, 3))):
        b = stack([make_sample(seed=s, n_views=3, img_size=(64, 64), n_vox=32,
                               voxel_size=0.08, device="cpu") for s in pair])
        b["scene_reset"] = np.full(2, 1.0 if k == 0 else 0.0, np.float32)
        frags.append(b)
    cpu_fw = nr_module.NeuralRecon(BLOCK_CFGS, device="cpu")
    gpu_fw = nr_module.NeuralRecon(BLOCK_CFGS)
    cpu_fw.init(0, frags[0])
    gpu_fw.init(0, frags[0])
    for (k, a), (_, g) in zip(cpu_fw.net.state_dict().items(),
                              gpu_fw.net.state_dict().items()):
        check(torch.equal(a, g.cpu()), f"seeded weights differ at {k}")
    c = _stream(nr_module, cpu_fw, frags)
    g = _stream(nr_module, gpu_fw, frags)
    check(len(c["ids"]) == len(g["ids"]) == 6, "expected 6 block selections")
    for lvl, (a, b) in enumerate(zip(c["ids"], g["ids"])):
        check(torch.equal(a, b), f"block ids differ at selection {lvl}")
    worst = 0.0
    for frag in ("o1", "o2"):
        for k in ("tsdf", "occ", "origin"):
            d = (c[frag][k] - g[frag][k]).abs().max().item()
            worst = max(worst, d)
            check(d <= TOL_SLICE, f"{frag}/{k}: CPU vs card differ by {d}")
    for lvl, (a, b) in enumerate(zip(c["hidden"], g["hidden"])):
        d = (a - b).abs().max().item()
        worst = max(worst, d)
        check(d <= TOL_SLICE, f"hidden level {lvl}: CPU vs card differ by {d}")
    rel = abs(c["val"] - g["val"]) / max(abs(c["val"]), 1e-12)
    check(rel <= TOL_VAL_RTOL, f"val_fn: CPU {c['val']} vs card {g['val']}")
    print(f"cpu_vs_card: block ids identical ({len(g['ids'])} selections), "
          f"max abs diff {worst:.3g} (tol {TOL_SLICE}: the bf16 "
          f"back-projection table turns float32 sum-order differences into "
          f"occasional one-ulp bf16 steps), val cpu={c['val']!r} "
          f"card={g['val']!r} rel={rel:.3g}", flush=True)


# ---------------------------------------------------------------- phase 4 --
def phase_full_width(nr_module, fused_loss, stack, make_sample, card,
                     profile_dir=None):
    phase("full width: bench.py config, 9x480x640, 96^3, block, bf16")
    # PyTorch's defaults, which a user of the port runs with (the port
    # flips no flag): TF32 for float32 convs, full float32 for matmuls
    set_tf32(cudnn=True, matmul=False)
    t0 = time.perf_counter()
    batch = stack([make_sample(seed=0, n_views=N_VIEWS, img_size=IMG_HW,
                               n_vox=N_VOX, voxel_size=0.04, device="cuda")])
    fw = nr_module.NeuralRecon(BENCH_CFGS)
    net, state = fw.init(0, batch)
    dev = fw.batch_to_device(batch)
    first = dict(dev, scene_reset=torch.ones(1, device=fw.device))
    cont = dict(dev, scene_reset=torch.zeros(1, device=fw.device))
    torch.cuda.synchronize()
    print(f"set-up (synthetic fragment, init) {time.perf_counter() - t0:.3f} s")

    fused_loss.launches = 0                       # the main path starts here
    torch.cuda.reset_peak_memory_stats()
    out, state = fw.forward_test(net, state, first)
    for _ in range(WARMUP - 1):
        out, state = fw.forward_test(net, state, cont)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED):
        out, state = fw.forward_test(net, state, cont)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TIMED
    lat = []
    for _ in range(TIMED):                        # one fragment at a time
        t0 = time.perf_counter()
        out, state = fw.forward_test(net, state, cont)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    val = fw.val_fn(net, state, cont)["log_vars"]["loss"]
    torch.cuda.synchronize()
    launches = fused_loss.launches                # ... and ends here
    peak = torch.cuda.max_memory_allocated()

    check(launches == 3, f"val_fn launched the fused loss {launches} times, "
          "expected 3 (one per level)")
    check(tuple(out["tsdf"].shape) == (1, N_VOX, N_VOX, N_VOX),
          f"tsdf shape {tuple(out['tsdf'].shape)}")
    for k in ("tsdf", "occ"):
        check(torch.isfinite(out[k]).all().item(), f"non-finite {k}")
    for v in state["global_hidden"].volumes:
        check(torch.isfinite(v).all().item(), "non-finite hidden state")
    check(bool(np.isfinite(float(val))), f"non-finite val loss {val}")
    occupied = int((out["tsdf"] != 1.0).sum().item())
    print(f"full_width: card={card!r} ms_per_fragment={dt * 1e3:.6f} "
          f"keyframes_per_s={N_VIEWS / dt:.6f} fragments_timed={TIMED} "
          f"synced_fragment_ms_median={statistics.median(lat):.6f} "
          f"synced_fragment_ms_max={max(lat):.6f} "
          f"max_memory_allocated_bytes={peak} val_loss={float(val)!r} "
          f"occupied_voxels={occupied} fused_loss_launches={launches} "
          f"max_blocks={fw.max_blocks}",
          flush=True)
    # no step of a fragment or of val_fn waits for the device: any
    # synchronising call (.item(), nonzero, a copy to the host) raises here
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    _, state = fw.forward_test(net, state, cont)
    fw.val_fn(net, state, cont)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("host syncs: none in forward_test and val_fn "
          "(torch.cuda.set_sync_debug_mode('error'))", flush=True)
    if profile_dir:
        profile(nr_module, fw, net, state, cont, profile_dir)
    return launches


# the framework's op calls, each wrapped in a profiler span by ``profile``
SPAN_OPS = ("back_project_batch", "back_project_masked_batch",
            "back_project_sparse_batch", "block_mask_from_voxels",
            "child_block_mask", "select_blocks", "block_voxel_indices",
            "dense_to_blocks", "blocks_to_dense", "blocks_to_dense_over",
            "gather_parent_octants", "read_windows_batch",
            "write_windows_batch", "fused_tsdf_occ_loss")
PROFILED_FRAGMENTS = 3


def _span_hooks(nr_module, net):
    """Profiler spans around the framework's op calls, ``gather_halo`` and
    the network's top-level modules (trunk, UNets, GRUs, heads).  Returns a
    function that removes them."""
    from torch.profiler import record_function

    import deep3dmap_tpu_torch.models.modulars.block_dense3d as bd
    undo = []

    def wrap(ns, name):
        f = getattr(ns, name)

        def spanned(*a, **kw):
            with record_function("span:" + name):
                return f(*a, **kw)
        setattr(ns, name, spanned)
        undo.append(lambda: setattr(ns, name, f))
    for name in SPAN_OPS:
        wrap(nr_module, name)
    wrap(bd, "gather_halo")
    open_spans = {}

    def pre(mod, inp, name):
        open_spans[name] = record_function("span:" + name)
        open_spans[name].__enter__()

    def post(mod, inp, out, name):
        open_spans.pop(name).__exit__(None, None, None)
    for name, m in net.named_children():
        m = getattr(m, "fpn", m)   # backbone2d's forward is its fpn's
        h1 = m.register_forward_pre_hook(lambda mod, inp, n=name: pre(mod, inp, n))
        h2 = m.register_forward_hook(lambda mod, inp, out, n=name: post(mod, inp, out, n))
        undo += [h1.remove, h2.remove]

    def remove():
        for u in reversed(undo):
            u()
    return remove


def profile(nr_module, fw, net, state, batch, out_dir):
    """torch.profiler over a few streamed fragments: the device's busy share,
    kernel launches per fragment, host and device time per layer span, and
    device time by kernel.  Writes ``kernels.txt`` into ``out_dir``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    os.makedirs(out_dir, exist_ok=True)
    remove = _span_hooks(nr_module, net)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_FRAGMENTS):
            _, state = fw.forward_test(net, state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    remove()
    avg = prof.key_averages()
    kernels = sorted(device_kernels(prof), key=lambda e: e.self_device_time_total,
                     reverse=True)
    busy_ms = kernel_us(prof) / 1e3
    n_launch = sum(e.count for e in kernels)
    per = PROFILED_FRAGMENTS
    lines = [f"profile: {per} fragments, host wall {wall_ms / per:.3f} ms per "
             f"fragment (profiler on), device kernel time {busy_ms / per:.3f} "
             f"ms per fragment = {100 * busy_ms / wall_ms:.2f}% busy, "
             f"{n_launch / per:.1f} kernel launches per fragment",
             "spans (per fragment): host ms incl. children | device ms | calls"]
    spans = sorted((e for e in avg if e.key.startswith("span:")
                    and e.device_type == DeviceType.CPU),
                   key=lambda e: e.cpu_time_total, reverse=True)
    for e in spans:
        lines.append(f"  {e.key[5:]:28s} {e.cpu_time_total / 1e3 / per:10.3f} "
                     f"{e.device_time_total / 1e3 / per:10.3f} {e.count / per:8.1f}")
    lines.append("kernels (per fragment): device ms | share | launches")
    for e in kernels[:30]:
        lines.append(f"  {e.self_device_time_total / 1e3 / per:10.3f} "
                     f"{100 * e.self_device_time_total / 1e3 / busy_ms:6.2f}% "
                     f"{e.count / per:8.1f} {e.key[:100]}")
    with open(os.path.join(out_dir, "kernels.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile the full-width stream into DIR")
    args = ap.parse_args()

    phase("device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a CUDA GPU")
    card = device_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}", flush=True)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import deep3dmap_tpu_torch.models.frameworks.neuralrecon as nr_module
    from deep3dmap_tpu_torch.datasets.builder import _stack_samples
    from deep3dmap_tpu_torch.datasets.synthetic import make_fragment_sample
    from deep3dmap_tpu_torch.ops import fused_loss

    t0 = time.perf_counter()
    loss = phase_kernel_vs_plain(fused_loss)
    phase_cpu_vs_card(nr_module, _stack_samples, make_fragment_sample)
    launches = phase_full_width(nr_module, fused_loss, _stack_samples,
                                make_fragment_sample, card, args.profile)
    print(f"phases took {time.perf_counter() - t0:.3f} s", flush=True)

    print(json.dumps({"kernels": [{
        "name": "fused_tsdf_occ_loss",
        "route": "triton",
        "source": "deep3dmap_tpu_torch/ops/fused_loss.py",
        "replaces": "deep3dmap_tpu/ops/pallas_loss.py:32",
        "launches": launches,
        "max_abs_err": loss["max_abs_err"],
        "ms": loss["ms"],
        "plain_ms": loss["plain_ms"],
        "bound_ms": loss["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
