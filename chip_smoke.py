#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``deep3dmap_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # the check: needs one CUDA card
    python3 chip_smoke.py --profile DIR    # also a torch.profiler pass at full
                                           # width, its tables into DIR

Phases; any error ends the run with a nonzero exit and no result line:

1. device: the card's name and power limit (``nvidia-smi``).
2. kernel vs plain: the fused TSDF/occupancy loss (one Triton kernel)
   against its plain PyTorch version on the card, at the three level sizes
   of the bench pyramid (1x24³, 1x48³, 1x96³, the dtypes ``val_fn`` gives
   it), a ragged size, an empty target, an all-zero mask, bf16 predictions,
   and two sizes called back to back (a ticket left unreset would show).
   Device time of the call (torch.profiler, inputs cold in the L2) and the
   time of one call with its host launch cost (CUDA events), beside the
   memory-rate bound.
3. CPU vs card: the small block config at float32 with TF32 off, same
   seeded weights, ``forward_test`` over 2 fragments with carried state and
   ``val_fn`` on the CPU and on the card; identical block ids.
4. full width: the ``bench.py`` NeuralRecon config (9 views at 480x640, 96³,
   block-sparse levels, bf16) with seeded weights; 2 warm-up plus 10 timed
   fragments through ``forward_test`` with carried state, then ``val_fn``,
   whose loss must launch the kernel exactly 3 times.
5. kernel vs plain (raster): the hard z-buffer raster (CUDA C++, built by
   ``nvcc`` from ``deep3dmap_tpu_torch/ops/csrc/raster_hard.cu`` into
   ``deep3dmap_tpu_torch/ops/_build/``) against its plain PyTorch version on
   the card: celeba's 128² renderer under seeded views at B = 1 and 4, a
   ragged 37x53 grid, vertices behind the camera with degenerate triangles,
   two sheets, a view with every pixel background, a zoomed grid whose
   triangles take the overflow path, a celeba view with vertices pulled
   near the camera (both paths), and a 128² mesh folded into a few pixels
   (atomic contention).  Equal bit for bit; the overflow count against the
   plain box rule; device times of every op the wrapper issues beside the
   bound.
6. CPU vs card (Gan2Shape): the small config at float32 with TF32 off, the
   same seeded weights, ``forward_test`` (hard raster) and the step-1 loss
   on the CPU and on the card.
7. full width (Gan2Shape): celeba's model config (128², nf 32, z_dim 512) in
   hard raster mode with seeded weights, one synthetic face: 3 warm-up and
   20 timed ``forward_test`` calls (one raster launch each, no host sync)
   in turns with the same model in splat mode, peak memory,
   ``forward_step1``, and the raster kernel against its plain version on
   this path's own inputs.

8. kernel vs plain (loss backward), run after phase 2: the Triton
   ``loss_bwd_kernel`` against ``fused_tsdf_occ_loss_bwd_plain`` on the
   card, given the same sums (from the forward kernel) and cotangents: the
   three level sizes in the dtypes ``loss_fn`` hands it, a ragged size with
   bf16 predictions, an empty target, an all-zero mask, bf16 predictions at
   96³, each of g_total, g_occ and g_tsdf alone, and once through autograd.
   Device time against the bytes bound.
9. CPU vs card (training), run after phase 3: the small block config at
   float32 with TF32 off, the same seeded weights, two ``train_step`` calls
   (clip + Adam) on the CPU and on the card; identical block ids, losses,
   every parameter's gradient, the parameters after the two steps.
10. full width (training), run after phase 4: the bench config with seeded
   weights, ``Adam(1e-3)`` after ``clip(1.0)`` as ``bench.py:218`` has it,
   the fragment and the state carried from step to step: 2 warm-up, 5 timed
   back to back and 5 synced steps; 3 loss forward and 3 backward launches
   per step, finite gradients, parameters that moved, no host sync, and the
   backward kernel against its plain version on this path's own inputs.
11. CPU vs card (Gan2Shape training), run after phase 7: the small config
   with batchsize 4, hard raster, float32, TF32 off, the same seeded
   weights, host-drawn lights, views and generator noise (its strength set
   to 0.1): two ``train_step`` calls of each mode (one Adam per head) and a
   ``fit_instance`` of stage_iters (2, 2, 2); logs, every head's gradient,
   the heads after the steps and after the instance; the raster on step 2's
   B = 4 input against its plain version.
12. full width (Gan2Shape training): celeba's model (128², z_dim 512,
   n_mlp 8, nf 32, batchsize 4, Adam 1e-4) in hard raster mode with seeded
   weights: 2 warm-up and 10 synced ``train_step`` calls per mode (raster
   launches 1 / 1 / 2 per step), only the mode's heads move, finite
   gradients, one ``fit_instance`` at cut stage_iters, the peak memory, the
   frozen generator and discriminator bitwise unchanged, one step of each
   mode under ``set_sync_debug_mode("error")``, and the raster against its
   plain version on step 2's and step 3's inputs; ``--profile DIR`` adds
   ``gan2shape_train_kernels.txt``.

13. determinism: two identical 3-step trainings on the card, bitwise equal
   after them (every parameter, and NeuralRecon's recurrent state): the
   small block NeuralRecon config through ``train_step`` and each Gan2Shape
   mode through ``Gan2ShapeRunner.train_step`` (hard raster), with the
   runners' cuDNN flags; a probe step of each under
   ``use_deterministic_algorithms(warn_only=True)`` lists any op PyTorch
   knows to be nondeterministic.
14. the CLIs at full width: a 480x640 fixture scene (36 frames, 4 fragments
   of 9 keyframes) through the port's data-gen, ``tools/train.py`` at the
   ``bench.py`` config on ``ScanNetDataset`` for one epoch (the runner's
   synced step time beside phase 10's bare step, the loader's time per
   sample, 3 + 3 loss launches per step, peak memory, no host sync in a
   step that does not log, the checkpoint), then ``tools/test.py`` on that
   checkpoint with ``evaluate`` (the host C++ op built and used).
15. learning check: ``tools/quality_regression.py``'s config and fixture
   through both CLIs at its 120 epochs; the trained model must beat the
   untrained one by its condition (F-score + 0.05, AbsRel lower).

The raster's launches in the kernels line are phase 7's and phase 12's
main paths together; the fused loss's are phase 4's (forward) or phase 10's
(backward) and phase 14's.  Before the last line it prints one
``{"kernels": [...]}`` line; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
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
# raster kernel vs plain: the same float32 ops in the same order (phase 5)
TOL_RASTER = 1e-6
# Gan2Shape CPU vs card (phase 6), the slice tests' tolerances
# (tests/test_torch_gan2shape.py): heads 1e-5, normals 4e-5 (they divide
# depth differences by the pixel spacing), rendered outputs 1e-4, losses
# 1e-4 relative
TOL_G2S = dict(depth=1e-5, albedo=1e-5, normal=4e-5, recon_depth=1e-4,
               recon_im=1e-4)
TOL_G2S_LOSS_RTOL = 1e-4

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
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
ADAM, CLIP = dict(type="Adam", lr=1e-3), dict(max_norm=1.0)   # bench.py:218


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


_T0 = time.perf_counter()


def phase(name: str):
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


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
WINDOWS = 3          # profiler windows per device time
TRITON_STAGES = ("loss_kernel",)   # ops/fused_loss.py


def device_kernels(prof, names=None):
    """The CUDA kernels of a torch.profiler profile (averaged by name),
    without the device-side copies of ranges (``span:`` ones and torch's
    ``Optimizer.step``); only those whose name holds one of ``names`` when
    given."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith(("span:", "Optimizer."))
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


def _profile_window(fn, arg_sets, reps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile as tprofile
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for r in range(reps):
            fn(*arg_sets[r % len(arg_sets)])
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / reps / 1e3
            for e in device_kernels(prof)}


def device_ops_ms(fn, arg_sets, reps: int = 64) -> dict:
    """Device time of one call by device op (kernels and memsets, by name):
    what ``reps`` calls issue, summed by torch.profiler, over ``reps``; of
    ``WINDOWS`` such windows the one with the median total (one window read
    0.011 and another 0.0066 ms for the same loss call)."""
    ws = [_profile_window(fn, arg_sets, reps) for _ in range(WINDOWS)]
    return sorted(ws, key=lambda d: sum(d.values()))[WINDOWS // 2]


def device_ms(fn, arg_sets, names=None, reps: int = 64) -> float:
    """Device time of one call: the device ops (those whose name holds one
    of ``names``, or all) that ``reps`` calls issue, over ``reps``; the
    median of ``WINDOWS`` windows."""
    sums = [sum(v for k, v in _profile_window(fn, arg_sets, reps).items()
                if names is None or any(n in k for n in names))
            for _ in range(WINDOWS)]
    return statistics.median(sums)


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
            # ms: the Triton kernel; wrapper_ms: every device op of the
            # call (the same: the wrapper issues nothing else); plain_ms:
            # the whole plain loss, sums and combine
            t = dict(ms=device_ms(kern, sets, names=TRITON_STAGES),
                     plain_ms=device_ms(plain, sets),
                     bound_ms=loss_bound_ms(args),
                     wrapper_ms=device_ms(kern, sets),
                     call_ms=call_ms(kern, sets),
                     plain_call_ms=call_ms(plain, sets))
            for k, v in t.items():
                timed[k] = timed.get(k, 0.0) + v
            line += " " + " ".join(f"{k}={v:.6f}" for k, v in t.items())
            line += f" input_copies={len(sets)}"
        print(line, flush=True)
    print("fused_loss per val_fn (3 levels): " + " ".join(
        f"{k}={v:.6f}" for k, v in timed.items()) + " (ms: device time of "
          "the kernel; wrapper_ms: of every device op of the call; plain_ms: "
          "of the whole plain loss; call_ms: one call with its host launch "
          f"cost; bound: bytes over {HBM_BYTES_PER_S / 1e12} TB/s)", flush=True)
    max_err = max(max_err, loss_back_to_back(fused_loss, gen))
    return dict(timed, max_abs_err=max_err)


def loss_back_to_back(fused_loss, gen) -> float:
    """Two sizes (528 and 7 programs) called in turns without a sync: each
    result equals its size's first bit for bit and the plain version within
    TOL_LOSS, so the last program reset the ticket every time."""
    sizes = {"96^3": loss_inputs(gen, (1, 96, 96, 96)),
             "24^3": loss_inputs(gen, (1, 24, 24, 24))}
    order = ["96^3", "24^3", "24^3", "96^3", "24^3", "96^3"]
    before = fused_loss.launches
    outs = [torch.stack(fused_loss.fused_tsdf_occ_loss(*sizes[k], pos_weight=1.5))
            for k in order]
    torch.cuda.synchronize()
    check(fused_loss.launches == before + len(order),
          f"back to back: {fused_loss.launches - before} launches for {len(order)} calls")
    err = 0.0
    for k, args in sizes.items():
        want = torch.stack(fused_loss.fused_tsdf_occ_loss_plain(*args, pos_weight=1.5))
        got = [o for o, name in zip(outs, order) if name == k]
        for g in got:
            check(torch.equal(g, got[0]), f"back to back {k}: {g.tolist()} vs "
                  f"{got[0].tolist()}")
        check(torch.allclose(got[0], want, **TOL_LOSS),
              f"back to back {k}: kernel {got[0].tolist()} vs plain {want.tolist()}")
        err = max(err, (got[0] - want).abs().max().item())
    print(f"fused_loss back to back {order}: every call equals its size's first "
          f"bit for bit, abs_err={err:.3g} against the plain version", flush=True)
    return err


# ---------------------------------------------------------------- phase 8 --
# backward kernel vs plain: the same elementwise ops in the same order, but
# exp, log and the FMAs Triton forms may differ by an ulp; a bf16 gradient
# may round that ulp to the next bf16 value
TOL_LOSS_BWD = {torch.float32: dict(rtol=1e-5, atol=1e-12),
                torch.bfloat16: dict(rtol=2 ** -7, atol=1e-12)}
BWD_STAGES = ("loss_bwd_kernel",)   # ops/fused_loss.py


def loss_bwd_bound_ms(args) -> float:
    """The five inputs read and d_tsdf, d_occ written (plus the 5 sums and 3
    cotangents) over the memory rate; a few dozen flops per element are far
    below the float32 rate."""
    t, x = args[0], args[1]
    nbytes = (sum(a.numel() * a.element_size() for a in args[:5])
              + t.numel() * t.element_size() + x.numel() * x.element_size() + 8 * 4)
    return nbytes / HBM_BYTES_PER_S * 1e3


def compare_loss_bwd(fused_loss, name, args, g) -> float:
    """The backward kernel against the plain version on one input, given the
    forward kernel's sums and the cotangents ``g``; returns the max abs
    difference and the kernel's (d_tsdf, d_occ)."""
    out = fused_loss.fused_tsdf_occ_loss_cuda(*args, pos_weight=1.5)
    before = fused_loss.bwd_launches
    got = fused_loss.fused_tsdf_occ_loss_bwd_cuda(*args, out, g, 1.5)
    again = fused_loss.fused_tsdf_occ_loss_bwd_cuda(*args, out, g, 1.5)
    want = fused_loss.fused_tsdf_occ_loss_bwd_plain(*args, out[3:], g, 1.5)
    torch.cuda.synchronize()
    check(fused_loss.bwd_launches == before + 2,
          f"{name}: the wrapper did not launch the backward kernel")
    err = 0.0
    for what, a, b, c in zip(("d_tsdf", "d_occ"), got, again, want):
        check(a.dtype == c.dtype and a.shape == c.shape,
              f"{name} {what}: {a.dtype} {tuple(a.shape)} vs {c.dtype} {tuple(c.shape)}")
        check(torch.equal(a, b), f"{name} {what}: two runs differ")
        check(torch.isfinite(a).all().item(), f"{name} {what}: non-finite")
        tol = TOL_LOSS_BWD[a.dtype]
        check(torch.allclose(a.float(), c.float(), **tol),
              f"{name} {what}: kernel vs plain max abs diff "
              f"{(a.float() - c.float()).abs().max().item()} (tol {tol})")
        err = max(err, (a.float() - c.float()).abs().max().item())
    return err, got


def phase_loss_bwd(fused_loss):
    phase("kernel vs plain: fused_tsdf_occ_loss backward (Triton) vs plain PyTorch")
    set_tf32(cudnn=False, matmul=False)
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, b, f32 = torch.bfloat16, torch.bool, torch.float32
    first = torch.tensor([1.0, 0.0, 0.0], device="cuda")

    def f32_mask(args):     # loss_fn hands the mask over as float32
        return args[:4] + (args[4].to(f32),)
    cases = [(f"level{i}_{d}^3", f32_mask(loss_inputs(gen, (1, d, d, d))), first)
             for i, d in enumerate((24, 48, 96))]
    cases += [("ragged_1000003_bf16", loss_inputs(gen, (1000003,), pred_dtype=bf16,
                                                  target_dtype=b), first),
              ("empty_target_48^3", loss_inputs(gen, (1, 48, 48, 48),
                                                empty_target=True),
               torch.tensor([1.0, 0.5, 0.25], device="cuda")),
              ("zero_mask_48^3", loss_inputs(gen, (1, 48, 48, 48), zero_mask=True),
               torch.tensor([1.0, 0.5, 0.25], device="cuda")),
              ("bf16_pred_96^3", loss_inputs(gen, (1, 96, 96, 96), pred_dtype=bf16,
                                             target_dtype=b), first)]
    alone = f32_mask(loss_inputs(gen, (1, 48, 48, 48)))
    for k, gname in enumerate(("g_total", "g_occ", "g_tsdf")):
        cases.append((f"{gname}_alone_48^3", alone,
                      torch.eye(3, device="cuda")[k].contiguous()))
    max_err, timed = 0.0, {}
    for name, args, g in cases:
        err, got = compare_loss_bwd(fused_loss, name, args, g)
        max_err = max(max_err, err)
        if name.startswith("zero_mask"):
            check(not any(d.any().item() for d in got), f"{name}: nonzero gradient")
        if name.startswith("empty_target"):
            check(not got[0].any().item(), f"{name}: nonzero tsdf gradient")
        line = (f"fused_loss_bwd {name}: n={args[0].numel()} dtypes="
                f"{[str(a.dtype).replace('torch.', '') for a in args]} "
                f"g={g.tolist()} abs_err={err:.3g}")
        if name.startswith("level"):
            t = time_loss_bwd(fused_loss, args, g)
            for k, v in t.items():
                timed[k] = timed.get(k, 0.0) + v
            line += " " + " ".join(f"{k}={v:.6f}" for k, v in t.items())
        print(line, flush=True)
    print("fused_loss_bwd per train step (3 levels): " + " ".join(
        f"{k}={v:.6f}" for k, v in timed.items()) + " (ms: device time of "
          "loss_bwd_kernel; plain_ms: of the plain backward; call_ms: one call "
          f"with its host launch; bound: bytes over {HBM_BYTES_PER_S / 1e12} TB/s; "
          f"tolerances {TOL_LOSS_BWD})", flush=True)
    max_err = max(max_err, loss_bwd_through_autograd(fused_loss, gen))
    return dict(timed, max_abs_err=max_err)


def time_loss_bwd(fused_loss, args, g) -> dict:
    """Device times of the backward kernel and of the plain backward on cold
    copies of one input, and the bytes bound."""
    out = fused_loss.fused_tsdf_occ_loss_cuda(*args, pos_weight=1.5)
    sets = cold_copies(tuple(args) + (out, g))

    def kern(*a):
        return fused_loss.fused_tsdf_occ_loss_bwd_cuda(*a[:5], a[5], a[6], 1.5)

    def plain(*a):
        return fused_loss.fused_tsdf_occ_loss_bwd_plain(*a[:5], a[5][3:], a[6], 1.5)
    return dict(ms=device_ms(kern, sets, names=BWD_STAGES),
                plain_ms=device_ms(plain, sets),
                bound_ms=loss_bwd_bound_ms(args),
                call_ms=call_ms(kern, sets))


def loss_bwd_through_autograd(fused_loss, gen) -> float:
    """``fused_tsdf_occ_loss`` differentiated by autograd launches each kernel
    once and gives the direct backward call's bits."""
    args = loss_inputs(gen, (1, 48, 48, 48))
    t = args[0].clone().requires_grad_()
    x = args[1].clone().requires_grad_()
    before = (fused_loss.launches, fused_loss.bwd_launches)
    losses = fused_loss.fused_tsdf_occ_loss(t, x, *args[2:], pos_weight=1.5)
    got = torch.autograd.grad(losses[0] * 0.8, (t, x))
    torch.cuda.synchronize()
    check((fused_loss.launches, fused_loss.bwd_launches) == (before[0] + 1, before[1] + 1),
          "autograd: expected one forward and one backward launch")
    g = torch.tensor([0.8, 0.0, 0.0], device="cuda")
    err, direct = compare_loss_bwd(fused_loss, "autograd_48^3", args, g)
    for a, b in zip(got, direct):
        check(torch.equal(a, b), "autograd: the Function's gradient differs from "
              "the direct backward call")
    print(f"fused_loss_bwd through autograd: 1 forward + 1 backward launch, equal "
          f"to the direct call bit for bit, abs_err={err:.3g}", flush=True)
    return err


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


# ---------------------------------------------------------------- phase 9 --
# CPU vs card, training.  The backward is sensitive to its forward: a ReLU
# input within the forward's float32 difference of 0 passes or blocks its
# gradient and GroupNorm spreads that over its group, so gradients agree
# to the tolerances measured between the port and JAX on the CPU
# (tests/test_torch_neuralrecon_train.py), not to float32 rounding.  Two Adam
# steps move a weight by at most ~1.0014 lr each, so two runs whose
# gradients differ in sign end at most 4.006 lr apart; the two runs' updates
# differed by 0.103 of their norm on an H100 (0.6% of the weights more than
# lr apart).
TOL_TRAIN = dict(loss_rtol=1e-4, leaf=5e-2, backbone_leaf=1e-1, whole=2e-2,
                 param_abs=4.006 * ADAM["lr"], update=0.25)


def _leaf_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30)).item()


def _train_two_steps(nr_module, train_mod, fw, frags):
    state = train_mod.init_train_state(fw, 0, frags[0], ADAM, CLIP)
    net = state.net
    ids, restore = _record_block_ids(nr_module)
    logs, grads = [], None
    for b in frags:
        state, log = train_mod.train_step(fw, state, b)
        logs.append({k: float(v) for k, v in log.items()})
        if grads is None:      # the first step's (clipped) gradients
            grads = {n: p.grad.detach().cpu().clone() for n, p in net.named_parameters()}
    restore()
    return dict(ids=ids, logs=logs, grads=grads,
                params={n: p.detach().cpu().clone() for n, p in net.named_parameters()})


def phase_train_cpu_vs_card(nr_module, train_mod, stack, make_sample):
    phase("CPU vs card: small block config, float32, 2 train steps (clip + Adam)")
    set_tf32(cudnn=False, matmul=False)
    frags = []
    for k, pair in enumerate(((0, 1), (2, 3))):
        b = stack([make_sample(seed=s, n_views=3, img_size=(64, 64), n_vox=32,
                               voxel_size=0.08, device="cpu") for s in pair])
        b["scene_reset"] = np.full(2, 1.0 if k == 0 else 0.0, np.float32)
        frags.append(b)
    cpu_fw = nr_module.NeuralRecon(BLOCK_CFGS, device="cpu")
    gpu_fw = nr_module.NeuralRecon(BLOCK_CFGS)
    c = _train_two_steps(nr_module, train_mod, cpu_fw, frags)
    g = _train_two_steps(nr_module, train_mod, gpu_fw, frags)
    # the seeded init, recomputed: both sides start from these weights
    cpu_fw.init(0, frags[0])
    p0 = {n: p.detach().clone() for n, p in cpu_fw.net.named_parameters()}
    check(len(c["ids"]) == len(g["ids"]) == 4, "expected 4 block selections")
    for k, (a, b) in enumerate(zip(c["ids"], g["ids"])):
        check(torch.equal(a, b), f"block ids differ at selection {k}")

    def rel(step, k):
        a, b = c["logs"][step][k], g["logs"][step][k]
        return abs(a - b) / max(abs(a), 1e-12)
    losses = [k for k in c["logs"][0] if k != "grad_norm"]
    loss1 = max(rel(0, k) for k in losses)
    loss2 = max(rel(1, k) for k in losses)
    names = list(c["grads"])
    leaf = {n: _leaf_rel(g["grads"][n], c["grads"][n]) for n in names}
    flat = lambda d: torch.cat([d[n].reshape(-1) for n in names])   # noqa: E731
    whole = _leaf_rel(flat(g["grads"]), flat(c["grads"]))
    gn_rel = rel(0, "grad_norm")
    p_abs = max((g["params"][n] - c["params"][n]).abs().max().item() for n in names)
    moved = sum(int((c["params"][n] != p0[n]).sum()) for n in names)
    apart = sum(int(((g["params"][n] - c["params"][n]).abs() > ADAM["lr"]).sum())
                for n in names)
    upd = _leaf_rel(flat(g["params"]) - flat(p0), flat(c["params"]) - flat(p0))
    print(f"train_cpu_vs_card: block ids identical ({len(g['ids'])} selections), "
          f"step-1 losses rel {loss1:.3g}, step-2 losses rel {loss2:.3g}, "
          f"grad norm cpu={c['logs'][0]['grad_norm']!r} "
          f"card={g['logs'][0]['grad_norm']!r}, gradients: max leaf rel "
          f"{max(leaf.values()):.3g} (off backbone2d "
          f"{max(v for n, v in leaf.items() if not n.startswith('backbone2d')):.3g}), "
          f"whole {whole:.3g}; parameters after 2 steps: max abs diff {p_abs:.3g}, "
          f"{apart} of {moved} moved weights more than lr apart, update rel {upd:.3g} "
          f"(tolerances {TOL_TRAIN})", flush=True)
    check(loss1 <= TOL_TRAIN["loss_rtol"], f"step-1 losses CPU vs card off by {loss1}")
    bad = {n: v for n, v in leaf.items() if v > TOL_TRAIN[
        "backbone_leaf" if n.startswith("backbone2d") else "leaf"]}
    check(not bad, f"gradients off per leaf: {bad}")
    check(whole <= TOL_TRAIN["whole"] and gn_rel <= TOL_TRAIN["whole"],
          f"whole gradient off by {whole}, its norm by {gn_rel}")
    check(p_abs <= TOL_TRAIN["param_abs"] and upd <= TOL_TRAIN["update"],
          f"parameters after 2 steps differ by {p_abs}, their updates by {upd}")


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
        import deep3dmap_tpu_torch.models.modulars.block_dense3d as bd
        st = [state]

        def fragment():
            st[0] = fw.forward_test(net, st[0], cont)[1]
        # the framework's op calls, gather_halo and the network's top-level
        # modules (trunk, UNets, GRUs, heads; backbone2d's forward is its fpn's)
        profile("profile", "fragment", fragment, PROFILED_FRAGMENTS,
                [(nr_module, n) for n in SPAN_OPS] + [(bd, "gather_halo")],
                [(n, getattr(m, "fpn", m)) for n, m in net.named_children()],
                os.path.join(profile_dir, "kernels.txt"))
    return launches


# ---------------------------------------------------------------- phase 10 --
def phase_train_full_width(nr_module, fused_loss, train_mod, stack,
                           make_sample, card, make_deterministic, profile_dir=None):
    phase("full width: training, bench.py config, 9x480x640, 96^3, clip + Adam")
    set_tf32(cudnn=True, matmul=False)   # PyTorch's defaults, as in phase 4
    make_deterministic()                 # as the runners and the CLIs set it
    t0 = time.perf_counter()
    batch = stack([make_sample(seed=0, n_views=N_VIEWS, img_size=IMG_HW,
                               n_vox=N_VOX, voxel_size=0.04, device="cuda")])
    fw = nr_module.NeuralRecon(BENCH_CFGS)
    state = train_mod.init_train_state(fw, 0, batch, ADAM, CLIP)
    net = state.net
    dev = fw.batch_to_device(batch)      # pinned on the card, as bench.py
    p0 = [p.detach().clone() for p in net.parameters()]
    torch.cuda.synchronize()
    print(f"set-up (synthetic fragment, init) {time.perf_counter() - t0:.3f} s")
    per_step, st = [], [state]

    def step():
        f0, b0 = fused_loss.launches, fused_loss.bwd_launches
        st[0], log = train_mod.train_step(fw, st[0], dev)
        per_step.append((fused_loss.launches - f0, fused_loss.bwd_launches - b0))
        return log

    fused_loss.launches = fused_loss.bwd_launches = 0   # the main path starts here
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_WARMUP):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        log = step()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_TIMED
    lat = []
    for _ in range(TRAIN_TIMED):                  # one step at a time
        t0 = time.perf_counter()
        log = step()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = (fused_loss.launches, fused_loss.bwd_launches)   # ... and ends here
    peak = torch.cuda.max_memory_allocated()

    n_steps = TRAIN_WARMUP + 2 * TRAIN_TIMED
    check(per_step == [(3, 3)] * n_steps,
          f"loss (forward, backward) launches per step: {per_step}, expected (3, 3)")
    check(launches == (3 * n_steps, 3 * n_steps), f"loss launches {launches}")
    log = {k: float(v) for k, v in log.items()}
    check(all(np.isfinite(v) for v in log.values()), f"non-finite log {log}")
    for n, p in net.named_parameters():
        check(p.grad is not None and torch.isfinite(p.grad).all().item(),
              f"missing or non-finite gradient at {n}")
    moved = sum(int((p.detach() != q).sum().item()) for p, q in zip(net.parameters(), p0))
    n_params = sum(p.numel() for p in p0)
    check(moved > 0.5 * n_params, f"only {moved} of {n_params} weights moved")
    for v in st[0].model_state["global_hidden"].volumes:
        check(torch.isfinite(v).all().item(), "non-finite hidden state")
    print(f"train_full_width: card={card!r} train_step_ms_median="
          f"{statistics.median(lat):.6f} train_step_ms_max={max(lat):.6f} "
          f"back_to_back_ms_per_step={dt * 1e3:.6f} "
          f"train_keyframes_per_s={N_VIEWS / dt:.6f} steps={n_steps} "
          f"max_memory_allocated_bytes={peak} "
          + " ".join(f"{k}={v!r}" for k, v in log.items())
          + f" loss_fwd_launches_per_step={launches[0] / n_steps} "
          f"loss_bwd_launches_per_step={launches[1] / n_steps} "
          f"weights_moved={moved}/{n_params}", flush=True)

    # no op of a step waits for the device, the backward's and Adam's
    # included: any synchronising call raises here
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    step()
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("host syncs: none in train_step "
          "(torch.cuda.set_sync_debug_mode('error'))", flush=True)

    # the backward kernel against its plain version on this path's inputs
    seen = []
    orig = fused_loss.fused_tsdf_occ_loss_bwd_cuda

    def spy(*a, **kw):
        seen.append(tuple(x.detach().clone() if torch.is_tensor(x) else x for x in a))
        return orig(*a, **kw)
    fused_loss.fused_tsdf_occ_loss_bwd_cuda = spy
    step()
    fused_loss.fused_tsdf_occ_loss_bwd_cuda = orig
    check(len(seen) == 3, f"{len(seen)} backward calls in one step")
    err, timed = 0.0, {}
    for a in seen:       # the backward meets the levels finest first
        args, out, g = a[:5], a[5], a[6]
        side = f"{args[0].shape[-1]}^3"
        e, _ = compare_loss_bwd(fused_loss, f"main_path_{side}", args, g)
        err = max(err, e)
        t = time_loss_bwd(fused_loss, args, g)
        for k, v in t.items():
            timed[k] = timed.get(k, 0.0) + v
        print(f"fused_loss_bwd main_path {side}: n={args[0].numel()} dtypes="
              f"{[str(x.dtype).replace('torch.', '') for x in args]} g={g.tolist()} "
              f"abs_err={e:.3g} " + " ".join(f"{k}={v:.6f}" for k, v in t.items()),
              flush=True)
    print("fused_loss_bwd main path per step (3 levels): " + " ".join(
        f"{k}={v:.6f}" for k, v in timed.items()), flush=True)
    if profile_dir:
        import deep3dmap_tpu_torch.models.modulars.block_dense3d as bd
        profile("train profile", "step", step, PROFILED_FRAGMENTS,
                [(nr_module, n) for n in SPAN_OPS] + [(bd, "gather_halo")],
                [(n, getattr(m, "fpn", m)) for n, m in net.named_children()],
                os.path.join(profile_dir, "train_kernels.txt"))
    return dict(timed, launches=launches[1], max_abs_err=err,
                step_ms_median=statistics.median(lat))


# the framework's op calls, each wrapped in a profiler span by ``profile``
SPAN_OPS = ("back_project_batch", "back_project_masked_batch",
            "back_project_sparse_batch", "block_mask_from_voxels",
            "child_block_mask", "select_blocks", "block_voxel_indices",
            "dense_to_blocks", "blocks_to_dense", "blocks_to_dense_over",
            "gather_parent_octants", "read_windows_batch",
            "write_windows_batch", "fused_tsdf_occ_loss")
PROFILED_FRAGMENTS = 3


def _span_hooks(wraps, modules):
    """Profiler spans around the functions that ``wraps`` names, as
    (namespace, name) or (namespace, name, span label) tuples, and around
    the forward of each (name, module) of ``modules``.  Returns a function
    that removes them."""
    from torch.profiler import record_function
    undo = []
    for ns, name, *label in wraps:
        f, own = getattr(ns, name), name in vars(ns)

        def spanned(*a, _f=f, _n=(label or [name])[0], **kw):
            with record_function("span:" + _n):
                return _f(*a, **kw)
        setattr(ns, name, spanned)
        # a method found on the class goes back to it; an attribute of the
        # namespace itself is put back
        undo.append(lambda ns=ns, n=name, f=f, own=own:
                    setattr(ns, n, f) if own else delattr(ns, n))
    open_spans = {}

    def pre(mod, inp, name):
        open_spans[name] = record_function("span:" + name)
        open_spans[name].__enter__()

    def post(mod, inp, out, name):
        open_spans.pop(name).__exit__(None, None, None)
    for name, m in modules:
        h1 = m.register_forward_pre_hook(lambda mod, inp, n=name: pre(mod, inp, n))
        h2 = m.register_forward_hook(lambda mod, inp, out, n=name: post(mod, inp, out, n))
        undo += [h1.remove, h2.remove]

    def remove():
        for u in reversed(undo):
            u()
    return remove


def profile(label, unit, call, n, wraps, modules, out_path, append=False):
    """torch.profiler over ``n`` calls of ``call`` (each one ``unit``): the
    device's busy share, kernel launches per unit, host and device time per
    span (``_span_hooks(wraps, modules)``), and device time by kernel.
    Writes the tables to ``out_path`` (after what it holds, ``append``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    remove = _span_hooks(wraps, modules)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    remove()
    avg = prof.key_averages()
    kernels = sorted(device_kernels(prof), key=lambda e: e.self_device_time_total,
                     reverse=True)
    busy_ms = kernel_us(prof) / 1e3
    n_launch = sum(e.count for e in kernels)
    lines = [f"{label}: {n} {unit}s, host wall {wall_ms / n:.3f} ms per "
             f"{unit} (profiler on), device kernel time {busy_ms / n:.3f} "
             f"ms per {unit} = {100 * busy_ms / wall_ms:.2f}% busy, "
             f"{n_launch / n:.1f} kernel launches per {unit}",
             f"spans (per {unit}): host ms incl. children | device ms | calls"]
    spans = sorted((e for e in avg if e.key.startswith("span:")
                    and e.device_type == DeviceType.CPU),
                   key=lambda e: e.cpu_time_total, reverse=True)
    for e in spans:
        lines.append(f"  {e.key[5:]:28s} {e.cpu_time_total / 1e3 / n:10.3f} "
                     f"{e.device_time_total / 1e3 / n:10.3f} {e.count / n:8.1f}")
    lines.append(f"kernels (per {unit}): device ms | share | launches")
    for e in kernels[:30]:
        lines.append(f"  {e.self_device_time_total / 1e3 / n:10.3f} "
                     f"{100 * e.self_device_time_total / 1e3 / busy_ms:6.2f}% "
                     f"{e.count / n:8.1f} {e.key[:100]}")
    with open(out_path, "a" if append else "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)


# ---------------------------------------------------------------- phase 5 --
# ops/csrc/raster_hard.cu: the device ops of one call (two memsets, three
# kernels); its time counts them all
RASTER_KERNELS = ("tri_kernel", "big_kernel", "finalize_kernel")
# per pixel-triangle test: dx2, dy2, two products,
# a sum and a product for each of l0 and l1, two subtractions for l2, three
# compares and an and
RASTER_OPS_PER_TEST = 15
# configs/gan2shape/celeba.py:26-37, with the checkpoint paths (gan_ckpt,
# parsing_ckpt; not in the repository) dropped and raster_mode="hard" added
CELEBA_MODEL_CFGS = dict(
    image_size=128, gan_size=128, z_dim=512, n_mlp=8, nf=32,
    channel_multiplier=1, batchsize=4,
    min_depth=0.9, max_depth=1.1,
    xyz_rotation_range=60, xy_translation_range=0.1, z_translation_range=0.1,
    lam_perc=1.0, lam_smooth=0.01, lam_regular=0.01,
    use_mask=True, category="face",
    raster_mode="hard")
G2S_SMALL_CFG = dict(image_size=32, gan_size=32, z_dim=32, n_mlp=4, nf=8,
                     batchsize=2, channel_multiplier=1, raster_mode="hard")


def raster_tests(points3d, K) -> float:
    """Pixel-triangle tests the function needs on these inputs, whatever
    the kernel's design: the pixel centres inside each valid triangle's
    bounding box (clipped to the image), summed over triangles.  Valid is
    the inside test's own ``ok``: a nonzero area and every z > EPS."""
    from deep3dmap_tpu_torch.ops.raster import (EPS, grid_mesh_triangles,
                                                project)
    px, py, z = project(points3d.float(), K.float())
    B, H, W = z.shape
    xs, ys, zs = grid_mesh_triangles(torch.stack([px, py], -1), z)
    x0, x1, x2 = xs.unbind(1)
    y0, y1, y2 = ys.unbind(1)
    denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
    ok = (denom.abs() > 1e-9) & (zs > EPS).all(1)

    def centres(a, n):   # integer pixel centres in [min, max] within [0, n-1]
        lo = torch.ceil(a.amin(1)).clamp(0, n)
        hi = torch.floor(a.amax(1)).clamp(-1, n - 1)
        return torch.nan_to_num(hi - lo + 1).clamp(min=0).double()
    return float((centres(xs, W) * centres(ys, H) * ok).sum())


def raster_bound(points3d, tests: float):
    """(bound ms, what bounds it): three float32 input grids read and one
    output written (16 B per pixel) over the memory rate, against the
    needed tests' operations over the float32 rate."""
    B, H, W, _ = points3d.shape
    bytes_ms = 16 * B * H * W / HBM_BYTES_PER_S * 1e3
    ops_ms = tests * RASTER_OPS_PER_TEST / F32_OPS_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _np_grid_points(rng, B, H, W, jitter, f=8.0):
    K = np.array([[f, 0, (W - 1) / 2], [0, f, (H - 1) / 2], [0, 0, 1]], np.float32)
    z = 1.0 + jitter * rng.rand(B, H, W).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    g = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K).T
    return (g[None] * z[..., None]).astype(np.float32), K


def _celeba_views(renderer_mod, B, seed):
    """Warped points of celeba's 128² renderer: a face-like canonical depth
    in [0.9, 1.1] under seeded views scaled as Gan2Shape scales them."""
    r = renderer_mod.NrRenderer(CELEBA_MODEL_CFGS, 128, device="cuda")
    rs = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, 128), np.linspace(-1, 1, 128),
                         indexing="ij")
    amp = rs.uniform(0.08, 0.15, (B, 1, 1))
    depth = 1.05 - amp * np.exp(-2 * (xx ** 2 + yy ** 2))
    depth = depth + rs.uniform(0, 0.003, (B, 128, 128))
    view = rs.uniform(-1, 1, (B, 6)) * np.array(
        [np.pi / 3] * 3 + [0.1] * 3)
    R, t = renderer_mod.get_transform_matrices(
        torch.from_numpy(view.astype(np.float32)).cuda())
    pts = r.get_warped_3d_grid(torch.from_numpy(depth.astype(np.float32)).cuda(),
                               R, t)
    return pts, r.K, r.max_depth


def raster_cases(renderer_mod):
    dev = "cuda"
    cases = []
    for B, seed in ((1, 0), (4, 1)):
        pts, K, bg = _celeba_views(renderer_mod, B, seed)
        cases.append((f"celeba_128^2_B{B}", pts, K, bg))

    def host(name, pts, K, bg=2.0):
        cases.append((name, torch.from_numpy(np.ascontiguousarray(pts)).to(dev),
                      torch.from_numpy(K).to(dev), bg))
    rng = np.random.RandomState(0)
    host("ragged_37x53", *_np_grid_points(rng, 1, 37, 53, jitter=0.3))
    pts, K = _np_grid_points(rng, 1, 40, 48, jitter=0.2)
    pts[0, 3:9, 4:12, 2] = -0.5          # behind the camera
    pts[0, 20, 10, 2] = 0.0              # on the camera plane
    pts[0, 25] = pts[0, 24]              # a collapsed row: zero-area quads
    pts[0, 30:33, 5:9] = pts[0, 30, 5]   # a collapsed patch
    pts[0, 35, 6:30] = pts[0, 35, 6] + np.linspace(0, 1, 24)[:, None] * \
        (pts[0, 35, 29] - pts[0, 35, 6])  # a row of collinear vertices
    host("behind_camera_degenerate_40x48", pts, K)
    sheet, K = _np_grid_points(rng, 1, 32, 32, jitter=0.0, f=16.0)
    host("two_sheet_64x32", np.concatenate([sheet, sheet * 1.5], axis=1), K)
    off, K = _np_grid_points(rng, 1, 64, 64, jitter=0.1)
    off[..., 0] += 100.0                 # the whole mesh off screen
    host("all_background_64^2", off, K)
    # a 128² grid seen 20x magnified: its on-screen triangles are ~20 pixels
    # wide, so their boxes exceed the fast path's and take the overflow path
    zoom, K = _np_grid_points(rng, 1, 128, 128, jitter=0.05)
    K = K.copy()
    K[0, 0] = K[1, 1] = 8.0 * 20
    host("zoomed_grid_128^2", zoom, K)
    # a celeba view with three patches of vertices pulled near the camera
    # (z > EPS): their triangles reach far and overflow, the rest stay fast
    pts, K, bg = _celeba_views(renderer_mod, 1, 2)
    pts = pts.clone()
    for r, c in ((30, 40), (64, 64), (90, 20)):
        pts[0, r:r + 3, c:c + 3, 2] = 0.02
    cases.append(("celeba_near_camera_128^2", pts, K, bg))
    # a 128² mesh folded into a 5x5-pixel patch: every pixel centre there is
    # covered by many triangles, whose hits contend for its word
    H = W = 128
    f, cx = 8.0, (W - 1) / 2
    rr, cc = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    u = 62.0 + 2.0 * np.sin(0.37 * cc) + 0.01 * rr
    v = 62.0 + 2.0 * np.sin(0.29 * rr) + 0.01 * cc
    z = 1.0 + 0.2 * rng.rand(H, W)
    fold = np.stack([(u - cx) / f * z, (v - cx) / f * z, z], -1)[None]
    K = np.array([[f, 0, cx], [0, f, cx], [0, 0, 1]], np.float32)
    host("folded_128^2", fold.astype(np.float32), K)
    return cases


def compare_raster(raster, name, pts, K, bg):
    """Kernel vs plain on one input, bit for bit; returns the max abs diff
    and the number of triangles that took the overflow path."""
    before = raster.launches
    got, n_big = raster.raster_grid_depth_hard_cuda(pts, K, bg, overflow=True)
    again = raster.raster_grid_depth_hard(pts, K, bg)
    want = raster.raster_grid_depth_hard_plain(pts, K, bg)
    torch.cuda.synchronize()
    check(raster.launches == before + 2, f"{name}: the wrapper did not launch the kernel")
    check(torch.equal(got, again), f"{name}: two runs differ")
    cov_g, cov_w = got != bg, want != bg
    n_diff = int((got != want).sum().item())
    err = (got - want).abs().max().item()
    check(torch.equal(cov_g, cov_w),
          f"{name}: coverage differs at {int((cov_g != cov_w).sum().item())} pixels")
    check(err <= TOL_RASTER, f"{name}: max abs diff {err} > {TOL_RASTER}")
    check(n_diff == 0, f"{name}: {n_diff} pixels differ from the plain version")
    n_big, n_plain = int(n_big.item()), int(raster.overflow_triangles_plain(pts, K))
    check(n_big == n_plain, f"{name}: {n_big} triangles took the overflow path, "
          f"the box rule gives {n_plain}")
    T = 2 * pts.shape[0] * (pts.shape[1] - 1) * (pts.shape[2] - 1)
    print(f"raster {name}: shape={tuple(pts.shape)} covered={int(cov_g.sum().item())}"
          f"/{got.numel()} unequal_pixels={n_diff} max_abs_diff={err:.3g} "
          f"coverage identical overflow_triangles={n_big}/{T}", flush=True)
    return err, n_big


def time_raster(raster, pts, K, bg):
    """Kernel and plain device times, the bound and what bounds it."""
    sets = [(pts.clone(), K, bg) for _ in range(4)]
    tests = raster_tests(pts, K)
    bound_ms, bound_by = raster_bound(pts, tests)
    ops = device_ops_ms(raster.raster_grid_depth_hard, sets)
    for k in RASTER_KERNELS:
        check(any(k in name for name in ops), f"raster: no {k} among {sorted(ops)}")
    other = [k for k in ops if not any(n in k for n in RASTER_KERNELS + ("Memset",))]
    check(not other, f"raster: the call issued device ops beside its own: {other}")
    print("raster device ops per call (ms): " + " ".join(
        f"{k[:40]!r}={v:.6f}" for k, v in sorted(ops.items())), flush=True)
    return dict(ms=sum(ops.values()),
                call_ms=call_ms(raster.raster_grid_depth_hard, sets),
                plain_ms=device_ms(raster.raster_grid_depth_hard_plain, sets,
                                   reps=4),
                bound_ms=bound_ms, bound_by=bound_by, tests=tests)


def phase_raster(raster, renderer_mod, cuda_build):
    phase("kernel vs plain: raster_grid_depth_hard (CUDA C++) vs plain PyTorch")
    set_tf32(cudnn=False, matmul=False)
    t0 = time.perf_counter()
    so = cuda_build.build("raster_hard")
    print(f"built {os.path.relpath(so)} in {time.perf_counter() - t0:.3f} s (set-up)")
    with open(so[:-3] + ".log") as f:
        print("ptxas: " + " | ".join(ln.strip() for ln in f
                                       if "registers" in ln or "spill" in ln))
    max_err = 0.0
    for name, pts, K, bg in raster_cases(renderer_mod):
        max_err = max(max_err, compare_raster(raster, name, pts, K, bg)[0])
        if name.startswith("celeba"):
            t = time_raster(raster, pts, K, bg)
            T = 2 * (pts.shape[1] - 1) * (pts.shape[2] - 1)
            print(f"raster {name} timing: " + " ".join(
                f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in t.items()) + f" unculled_tests="
                f"{pts.shape[0] * pts.shape[1] * pts.shape[2] * T} (ms: device "
                "time of every op of the call, memsets included; call_ms: one "
                "call with its host launch)", flush=True)
    return max_err


# ---------------------------------------------------------------- phase 6 --
def _g2s_outputs(fw, net, batch):
    out, _ = fw.forward_test(net, {}, batch)
    total, log, _ = fw.forward_step1(net, {}, batch)
    res = {k: v.detach().float().cpu() for k, v in out.items()}
    res["loss"] = float(total.detach())
    res.update({k: float(v.detach()) for k, v in log.items()})
    return res


def phase_g2s_cpu_vs_card(g2s_module, dataset_cls):
    phase("CPU vs card: Gan2Shape small config (32², nf 8), hard raster, float32")
    set_tf32(cudnn=False, matmul=False)
    batch = dataset_cls(n_samples=1, image_size=32, z_dim=32).setup_input(0)
    cpu_fw = g2s_module.Gan2Shape(G2S_SMALL_CFG, device="cpu")
    gpu_fw = g2s_module.Gan2Shape(G2S_SMALL_CFG)
    cnet, _ = cpu_fw.init(0, batch)
    gnet, _ = gpu_fw.init(0, batch)
    for (k, a), (_, g) in zip(cnet.state_dict().items(), gnet.state_dict().items()):
        check(torch.equal(a, g.cpu()), f"seeded weights differ at {k}")
    c = _g2s_outputs(cpu_fw, cnet, batch)
    g = _g2s_outputs(gpu_fw, gnet, batch)
    bg = cpu_fw.max_depth
    check(torch.equal(c["recon_depth"] != bg, g["recon_depth"] != bg),
          "recon_depth coverage differs between the CPU and the card")
    diffs = {}
    for k, tol in TOL_G2S.items():
        d = (c[k] - g[k]).abs().max().item()
        diffs[k] = d
        check(d <= tol, f"{k}: CPU vs card differ by {d} > {tol}")
    for k in ("loss", "loss_l1", "loss_perc", "loss_smooth"):
        rel = abs(c[k] - g[k]) / max(abs(c[k]), 1e-12)
        diffs[k + "_rel"] = rel
        check(rel <= TOL_G2S_LOSS_RTOL, f"{k}: CPU {c[k]!r} vs card {g[k]!r}")
    print("g2s_cpu_vs_card: coverage identical, " + " ".join(
        f"{k}={v:.3g}" for k, v in diffs.items()) + f" (tolerances {TOL_G2S}, "
          f"losses rel {TOL_G2S_LOSS_RTOL})", flush=True)


# ---------------------------------------------------------------- phase 7 --
G2S_WARMUP, G2S_TIMED, G2S_STEP1_TIMED = 3, 20, 10
# the renderer's steps, each a span of the --profile pass
G2S_SPAN_METHODS = ("warp_canon_depth", "raster_depth", "get_normal_from_depth",
                    "get_inv_warped_2d_grid", "_grid_sample_images")
G2S_PROFILED = 3


def phase_g2s_full_width(g2s_module, raster, dataset_cls, card, profile_dir=None):
    phase("full width: Gan2Shape, configs/gan2shape/celeba.py model, 128², hard raster")
    # PyTorch's defaults, as a user of the port runs: TF32 for float32
    # convs, full float32 for matmuls
    set_tf32(cudnn=True, matmul=False)
    t0 = time.perf_counter()
    data = dataset_cls(n_samples=1, image_size=128, z_dim=512).setup_input(0)
    fw = g2s_module.Gan2Shape(CELEBA_MODEL_CFGS)
    net, state = fw.init(0, data)
    batch = fw.batch_to_device(data)
    torch.cuda.synchronize()
    print(f"set-up (synthetic face, init) {time.perf_counter() - t0:.3f} s")

    splat_fw = g2s_module.Gan2Shape(dict(CELEBA_MODEL_CFGS, raster_mode="splat"))
    splat_net, _ = splat_fw.init(0, data)
    splat_net.load_state_dict(net.state_dict())

    def splat():
        return splat_fw.forward_test(splat_net, state, batch)[0]
    per_call = []

    def hard():
        before = raster.launches
        out, _ = fw.forward_test(net, state, batch)
        per_call.append(raster.launches - before)
        return out

    def synced_ms(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    # the main path, hard mode, with splat mode's calls between its calls
    # (splat launches no raster kernel): the two modes are timed in turns,
    # hard first on even turns and splat first on odd ones, since the
    # host-bound call time drifts within a run
    raster.launches = 0                           # the main path starts here
    for _ in range(G2S_WARMUP):
        out = hard()
        splat()
    torch.cuda.synchronize()
    lat, splat_lat = [], []
    for i in range(G2S_TIMED):
        for mode in (("hard", "splat") if i % 2 == 0 else ("splat", "hard")):
            if mode == "hard":
                ms, out = synced_ms(hard)
                lat.append(ms)
            else:
                splat_lat.append(synced_ms(splat)[0])
    launches = raster.launches                    # ... and ends here
    check(all(n == 1 for n in per_call),
          f"raster launches per forward_test: {per_call} (expected 1 each)")
    check(launches == G2S_WARMUP + G2S_TIMED, f"raster launched {launches} times")
    S = CELEBA_MODEL_CFGS["image_size"]
    for k, shape in (("depth", (1, S, S)), ("albedo", (1, S, S, 3)),
                     ("normal", (1, S, S, 3)), ("recon_im", (1, S, S, 3)),
                     ("recon_depth", (1, S, S))):
        check(tuple(out[k].shape) == shape, f"{k} shape {tuple(out[k].shape)}")
        check(torch.isfinite(out[k]).all().item(), f"non-finite {k}")
    covered = int((out["recon_depth"] != fw.max_depth).sum().item())
    check(covered > 0, "the hard raster covered no pixel")

    # peak over one call, total and above what was allocated before it
    # (both models' weights stay allocated throughout)
    peaks = {}
    for name, fn in (("hard", hard), ("splat", splat)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        peaks[name] = f"max_memory_allocated_bytes={peak} call_peak_bytes={peak - held}"
    weight_bytes = sum(p.numel() * p.element_size() for m in (net, fw.perceptual.net)
                       for p in m.parameters())
    t0 = time.perf_counter()
    for _ in range(G2S_TIMED):
        fw.forward_test(net, state, batch)
    torch.cuda.synchronize()
    b2b_ms = (time.perf_counter() - t0) * 1e3 / G2S_TIMED

    step1 = lambda: fw.forward_step1(net, state, batch)   # noqa: E731
    for _ in range(G2S_WARMUP):
        step1()
    step1_lat = [synced_ms(step1)[0] for _ in range(G2S_STEP1_TIMED)]
    loss = float(step1()[0].detach())
    check(np.isfinite(loss), f"non-finite step-1 loss {loss}")

    med = statistics.median(lat)
    print(f"g2s_full_width: card={card!r} raster_mode=hard B=1 S={S} "
          f"forward_test_ms_median={med:.6f} forward_test_ms_max={max(lat):.6f} "
          f"instances_per_s={1e3 / med:.6f} back_to_back_ms={b2b_ms:.6f} "
          f"forward_step1_ms_median={statistics.median(step1_lat):.6f} "
          f"forward_step1_ms_max={max(step1_lat):.6f} step1_loss={loss!r} "
          f"{peaks['hard']} weight_bytes_per_model={weight_bytes} "
          f"raster_launches={launches} covered_pixels={covered}", flush=True)
    print(f"g2s_full_width: raster_mode=splat forward_test_ms_median="
          f"{statistics.median(splat_lat):.6f} forward_test_ms_max={max(splat_lat):.6f} "
          f"instances_per_s={1e3 / statistics.median(splat_lat):.6f} "
          f"{peaks['splat']} (timed in turns with hard "
          f"mode, {G2S_TIMED} calls each)", flush=True)

    # no step of forward_test waits for the device
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    fw.forward_test(net, state, batch)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("host syncs: none in Gan2Shape forward_test "
          "(torch.cuda.set_sync_debug_mode('error'))", flush=True)

    # the raster kernel against its plain version on this path's own input
    seen = []
    orig = fw.renderer.raster_depth
    fw.renderer.raster_depth = lambda p: (seen.append(p.detach().clone()), orig(p))[1]
    fw.forward_test(net, state, batch)
    del fw.renderer.raster_depth                 # back to the class's method
    pts = seen[0]
    err, n_big = compare_raster(raster, "main_path_celeba_128^2_B1", pts,
                                fw.renderer.K, fw.max_depth)
    t = time_raster(raster, pts, fw.renderer.K, fw.max_depth)
    print("raster main_path timing: " + " ".join(
        f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in t.items()), flush=True)
    if profile_dir:
        # the heads and the renderer's steps
        profile("gan2shape profile", "call",
                lambda: fw.forward_test(net, state, batch), G2S_PROFILED,
                [(fw.renderer, n) for n in G2S_SPAN_METHODS],
                list(net.named_children()),
                os.path.join(profile_dir, "gan2shape_kernels.txt"))
    return dict(t, launches=launches, max_abs_err=err, overflow=n_big)


# ---------------------------------------------------------------- phase 11 --
# Gan2Shape training, CPU vs card: tests/test_gan2shape.py:22-23's config
# with celeba's batchsize 4 (step 2's raster input is then B = 4, as at full
# width), hard raster, float32, TF32 off.  The gradients are measured as
# phase 9 measures them; the step-3 gradient is ill-conditioned (the port's
# own moves by up to 4e-3 per leaf when its input is scaled by 1 + 1e-6,
# tests/test_torch_gan2shape_train.py).  Adam moves a weight by about lr
# per step whatever its gradient's size, so after n steps two runs end at
# most ~2n lr apart where a gradient's sign differs, and a loss read after
# such a step differs more.  On an H100 (two runs): each mode's first step
# within 1.1e-6, step 2's second within 1.2e-3 (its latent norm, a mean of
# small squares), the fit's stage means within 3.0e-3 and 4.9e-3 (the
# card's scatter-adds use atomics: its runs differ); gradients per leaf
# within 3.4e-4, whole 2.2e-4; the heads after 6 steps 1.9e-4 apart
# (update rel 0.014), after the fit 2.8e-4 (0.042).
G2S_ADAM = dict(type="Adam", lr=1e-4)          # configs/gan2shape/celeba.py:41
G2S_MODES = ("step1", "step2", "step3")
G2S_TRAIN_SMALL_CFG = dict(G2S_SMALL_CFG, batchsize=4)
G2S_SMALL_FIT = (2, 2, 2)
TOL_G2S_TRAIN = dict(loss_rtol=1e-5, curve_rtol=3e-2, leaf=1e-2, whole=5e-3,
                     param_abs=2.01 * 12 * G2S_ADAM["lr"], update=0.25)


def _host_drawn(fw, cpu_fw, seed: int):
    """Make ``fw`` draw its pseudo images' lights and views and its
    generator's noise from CPU generators seeded from ``seed`` (copied to
    its device), so the CPU and the card get the same draws.  Returns a
    function that undoes it."""
    gd = torch.Generator().manual_seed(seed)
    gn = torch.Generator().manual_seed(seed + 1)
    make_noise, draws = type(fw.generator).make_noise, type(cpu_fw).pseudo_draws
    fw.pseudo_draws = lambda rng, b: {
        k: v.to(fw.device) for k, v in draws(cpu_fw, gd, b).items()}
    fw.generator.make_noise = lambda batch, gen: [
        n.to(fw.device) for n in make_noise(fw.generator, batch, gn)]

    def undo():
        del fw.pseudo_draws
        del fw.generator.make_noise
    return undo


def _spy_raster(fw, step):
    """The raster inputs of one ``step()``, and what it returned."""
    seen, orig = [], fw.renderer.raster_depth
    fw.renderer.raster_depth = lambda p: (seen.append(p.detach().clone()), orig(p))[1]
    try:
        out = step()
    finally:
        del fw.renderer.raster_depth
    return seen, out


def _g2s_snapshot(net):
    return {n: p.detach().cpu().clone() for n, p in net.named_parameters()}


def _g2s_train_run(runner_mod, raster, fw, cpu_fw, data):
    """Two steps of each mode, then one ``fit_instance``; host-drawn
    randomness and ``noise_strength`` 0.1, so the noise enters."""
    undo = _host_drawn(fw, cpu_fw, 11)
    r = runner_mod.Gan2ShapeRunner(fw, G2S_ADAM, stage_iters=G2S_SMALL_FIT, num_stage=1)
    net, state = r.setup(data)
    with torch.no_grad():
        for m in fw.generator.modules():
            if hasattr(m, "noise_strength"):
                m.noise_strength.fill_(0.1)
    p0 = _g2s_snapshot(net)
    dev = fw.batch_to_device(data)
    b2 = dict(dev, **r._collect_canon(dev))
    proj, mask = r._collect_pool(b2)
    batches = dict(step1=dev, step2=b2, step3=dict(dev, proj_im=proj[:4],
                                                   proj_mask=mask[:4]))
    logs, grads, seen = {}, {}, []
    for mode in G2S_MODES:
        for k in range(2):
            if fw.device.type == "cuda" and (mode, k) == ("step2", 0):
                seen, log = _spy_raster(fw, lambda: r.train_step(mode, batches[mode]))
            else:
                log = r.train_step(mode, batches[mode])
            logs[mode, k] = {n: float(v) for n, v in log.items()}
            if k == 0:
                grads[mode] = {n: p.grad.detach().cpu().clone()
                               for n, p in net.named_parameters() if p.grad is not None}
    params = _g2s_snapshot(net)
    r.fit_instance(data)
    undo()
    return dict(p0=p0, logs=logs, grads=grads, params=params, fit=_g2s_snapshot(net),
                fit_logs=r.logs[-1], seen=seen)


def phase_g2s_train_cpu_vs_card(g2s_module, runner_mod, raster, dataset_cls):
    phase("CPU vs card: Gan2Shape training, small config (32², nf 8, B 4), "
          "hard raster, float32, 2 steps per mode + fit_instance")
    set_tf32(cudnn=False, matmul=False)
    data = dataset_cls(n_samples=1, image_size=32, z_dim=32).setup_input(0)
    cpu_fw = g2s_module.Gan2Shape(G2S_TRAIN_SMALL_CFG, device="cpu")
    gpu_fw = g2s_module.Gan2Shape(G2S_TRAIN_SMALL_CFG)
    c = _g2s_train_run(runner_mod, raster, cpu_fw, cpu_fw, data)
    g = _g2s_train_run(runner_mod, raster, gpu_fw, cpu_fw, data)
    for n in c["p0"]:
        check(torch.equal(c["p0"][n], g["p0"][n]), f"seeded weights differ at {n}")

    def rel(a, b):
        return abs(a - b) / max(abs(a), 1e-12)
    loss_rel = {f"{m}.{k}": max(rel(c["logs"][m, k][n], g["logs"][m, k][n])
                                for n in c["logs"][m, k])
                for m in G2S_MODES for k in range(2)}
    fit_rel = max(rel(v, g["fit_logs"][n]) for n, v in c["fit_logs"].items()
                  if isinstance(v, float))
    leaf, whole = {}, {}
    for m in G2S_MODES:
        names = sorted(c["grads"][m])
        check(names == sorted(g["grads"][m]), f"{m}: gradients reach other leaves")
        leaf[m] = max(_leaf_rel(g["grads"][m][n], c["grads"][m][n]) for n in names)
        whole[m] = _leaf_rel(torch.cat([g["grads"][m][n].reshape(-1) for n in names]),
                             torch.cat([c["grads"][m][n].reshape(-1) for n in names]))
    names = list(c["p0"])
    flat = lambda d: torch.cat([d[n].reshape(-1) for n in names])   # noqa: E731
    p_abs = {k: max((g[k][n] - c[k][n]).abs().max().item() for n in names)
             for k in ("params", "fit")}
    upd = {k: _leaf_rel(flat(g[k]) - flat(c["p0"]), flat(c[k]) - flat(c["p0"]))
           for k in ("params", "fit")}
    print("g2s_train_cpu_vs_card: logs rel by step " + " ".join(
        f"{k}={v:.3g}" for k, v in loss_rel.items()) + f" fit_instance stage means "
          f"rel {fit_rel:.3g}; gradients max leaf rel " + " ".join(
        f"{m}={v:.3g}" for m, v in leaf.items()) + " whole " + " ".join(
        f"{m}={v:.3g}" for m, v in whole.items()) + "; parameters after the 6 steps: "
          f"max abs diff {p_abs['params']:.3g} update rel {upd['params']:.3g}; after "
          f"fit_instance {G2S_SMALL_FIT}: max abs diff {p_abs['fit']:.3g} update rel "
          f"{upd['fit']:.3g} (tolerances {TOL_G2S_TRAIN})", flush=True)
    first = max(v for k, v in loss_rel.items() if k.endswith(".0"))
    check(first <= TOL_G2S_TRAIN["loss_rtol"]
          and max(max(loss_rel.values()), fit_rel) <= TOL_G2S_TRAIN["curve_rtol"],
          f"losses CPU vs card off: {loss_rel}, fit_instance {fit_rel}")
    check(max(leaf.values()) <= TOL_G2S_TRAIN["leaf"]
          and max(whole.values()) <= TOL_G2S_TRAIN["whole"],
          f"gradients off: per leaf {leaf}, whole {whole}")
    check(max(p_abs.values()) <= TOL_G2S_TRAIN["param_abs"]
          and max(upd.values()) <= TOL_G2S_TRAIN["update"],
          f"parameters off: {p_abs}, updates {upd}")
    # the raster on step 2's B = 4 input, against its plain version
    check(len(g["seen"]) == 1 and g["seen"][0].shape[0] == 4,
          f"step 2 rasterised {[tuple(p.shape) for p in g['seen']]}")
    compare_raster(raster, "step2_small_B4", g["seen"][0], gpu_fw.renderer.K,
                   gpu_fw.max_depth)


# ---------------------------------------------------------------- phase 12 --
G2S_TRAIN_WARMUP, G2S_TRAIN_TIMED = 2, 10
G2S_FIT_ITERS = (20, 20, 20)        # celeba: (600, 600, 400) x 4 stages
RASTER_PER_STEP = dict(step1=1, step2=1, step3=2)
# the configuration without use_mask, whose mask comes from the parsing model
CELEBA_TRAIN_CFGS = dict(CELEBA_MODEL_CFGS, use_mask=False)


def phase_g2s_train_full_width(g2s_module, runner_mod, raster, dataset_cls, card,
                               profile_dir=None):
    phase("full width: Gan2Shape training, configs/gan2shape/celeba.py model, 128², "
          "hard raster, Adam 1e-4")
    set_tf32(cudnn=True, matmul=False)   # PyTorch's defaults, as in phase 7
    print(f"left out: gan_ckpt and parsing_ckpt (the files are not in the "
          f"repository: seeded weights instead), use_mask (needs the parsing "
          f"model); stage_iters cut from (600, 600, 400) x 4 stages to "
          f"{G2S_FIT_ITERS} x 1 stage", flush=True)
    t0 = time.perf_counter()
    data = dataset_cls(n_samples=1, image_size=128, z_dim=512).setup_input(0)
    fw = g2s_module.Gan2Shape(CELEBA_TRAIN_CFGS)
    r = runner_mod.Gan2ShapeRunner(fw, G2S_ADAM, stage_iters=G2S_FIT_ITERS, num_stage=1)
    net, state = r.setup(data)
    frozen = {f"{k}.{n}": t.clone() for k, m in (("g", fw.generator), ("d", fw.discriminator))
              for n, t in m.state_dict().items()}
    dev = fw.batch_to_device(data)
    torch.cuda.synchronize()
    print(f"set-up (synthetic face, init) {time.perf_counter() - t0:.3f} s")

    per_step = {m: [] for m in G2S_MODES}
    batches = dict(step1=dev)

    def step(mode):
        before = raster.launches
        log = r.train_step(mode, batches[mode])
        per_step[mode].append(raster.launches - before)
        return log

    raster.launches = 0                           # the main path starts here
    torch.cuda.reset_peak_memory_stats()
    batches["step2"] = dict(dev, **r._collect_canon(dev))
    with torch.no_grad():
        _, _, o = fw.forward_step2(net, state, batches["step2"], r.rng)
    batches["step3"] = dict(dev, proj_im=o["proj_im"], proj_mask=o["mask"])
    lat, logs = {}, {}
    for mode in G2S_MODES:
        for _ in range(G2S_TRAIN_WARMUP):
            step(mode)
        torch.cuda.synchronize()
        lat[mode] = []
        for _ in range(G2S_TRAIN_TIMED):
            t1 = time.perf_counter()
            step(mode)
            torch.cuda.synchronize()
            lat[mode].append((time.perf_counter() - t1) * 1e3)
        # one more step: only the mode's heads move, their gradients finite
        before = _g2s_snapshot(net)
        logs[mode] = {k: float(v) for k, v in step(mode).items()}
        check(all(np.isfinite(v) for v in logs[mode].values()),
              f"{mode}: non-finite log {logs[mode]}")
        for name, head in net.named_children():
            trains = name in runner_mod.MODE_NETS[mode]
            ps = dict(head.named_parameters())
            moved = [n for n, p in ps.items()
                     if not torch.equal(p.detach().cpu(), before[f"{name}.{n}"])]
            if trains:
                check(bool(moved), f"{mode}: {name} did not move")
                for n, p in ps.items():
                    check(p.grad is not None and torch.isfinite(p.grad).all().item(),
                          f"{mode}: missing or non-finite gradient at {name}.{n}")
            else:
                check(not moved, f"{mode}: {name} moved ({moved[:3]})")
                check(all(p.grad is None for p in ps.values()),
                      f"{mode}: a gradient reached {name}")
    t1 = time.perf_counter()
    before = raster.launches
    r.fit_instance(data)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    fit_launches = raster.launches - before
    launches = raster.launches                    # ... and ends here
    peak = torch.cuda.max_memory_allocated()

    for mode, n in RASTER_PER_STEP.items():
        check(per_step[mode] == [n] * len(per_step[mode]),
              f"{mode}: raster launches per step {per_step[mode]}, expected {n}")
    s1, s2, s3 = G2S_FIT_ITERS
    want = 1 + s1 + s2 + max(s2 // 4, 1) + 2 * s3     # + the canon snapshot, the pool
    check(fit_launches == want, f"fit_instance launched the raster {fit_launches} "
          f"times, expected {want}")
    for k, m in (("g", fw.generator), ("d", fw.discriminator)):
        for n, t in m.state_dict().items():
            check(torch.equal(t, frozen[f"{k}.{n}"]), f"frozen {k}.{n} changed")
    fit_logs = r.logs[-1]
    check(all(np.isfinite(v) for v in fit_logs.values() if isinstance(v, float)),
          f"non-finite fit_instance logs {fit_logs}")
    print(f"g2s_train_full_width: card={card!r} B={fw.batchsize} S={fw.image_size} "
          + " ".join(f"g2s_{m}_ms_median={statistics.median(lat[m]):.6f} "
                     f"g2s_{m}_ms_max={max(lat[m]):.6f}" for m in G2S_MODES)
          + f" synced_steps_per_mode={G2S_TRAIN_TIMED} fit_instance_s={fit_s:.6f} "
          f"stage_iters={G2S_FIT_ITERS} num_stage=1 max_memory_allocated_bytes={peak} "
          + " ".join(f"raster_launches_per_{m}={per_step[m][0]}" for m in G2S_MODES)
          + f" fit_instance_raster_launches={fit_launches} raster_launches={launches}",
          flush=True)
    print("g2s_train_full_width logs: " + " ".join(
        f"{m}.{k}={v!r}" for m in G2S_MODES for k, v in logs[m].items()), flush=True)
    print("g2s_train_full_width fit_instance stage means: " + " ".join(
        f"{k}={v!r}" for k, v in fit_logs.items()), flush=True)
    print("frozen generator and discriminator: bitwise unchanged", flush=True)

    # no op of a step waits for the device, in any mode
    for mode in G2S_MODES:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        step(mode)
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("host syncs: none in train_step step1/step2/step3 "
          "(torch.cuda.set_sync_debug_mode('error'))", flush=True)

    # the raster on this path's own B = 4 inputs (step 2's pseudo images,
    # step 3's projected samples) against its plain version, bit for bit
    res = {}
    for mode in ("step2", "step3"):
        for pts in _spy_raster(fw, lambda: step(mode))[0]:
            name = f"main_path_{mode}_B{pts.shape[0]}"
            err, n_big = compare_raster(raster, name, pts, fw.renderer.K, fw.max_depth)
            res[name] = dict(time_raster(raster, pts, fw.renderer.K, fw.max_depth),
                             max_abs_err=err)
            print(f"raster {name} timing: " + " ".join(
                f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in res[name].items()), flush=True)
    if profile_dir:
        spans = ([(fw.renderer, n) for n in G2S_SPAN_METHODS]
                 + [(fw.discriminator, "features", "discriminator"),
                    (torch.Tensor, "backward", "backward")]
                 + [(o, "step", "optimizer") for o in r.optimizers.values()])
        modules = list(net.named_children()) + [
            ("generator", fw.generator), ("vgg", fw.perceptual.net)]
        for i, mode in enumerate(G2S_MODES):
            profile(f"gan2shape train profile {mode}", "step", lambda: step(mode),
                    G2S_PROFILED, spans, modules,
                    os.path.join(profile_dir, "gan2shape_train_kernels.txt"),
                    append=i > 0)
    return dict(launches=launches, max_abs_err=max(v["max_abs_err"] for v in res.values()))


# ---------------------------------------------------------------- phase 13 --
DET_STEPS = 3


def _nondeterministic_ops(step):
    """The ops that PyTorch names as having no deterministic implementation
    while ``step()`` runs under ``use_deterministic_algorithms(warn_only)``
    (a probe: the mode swaps some kernels, so its step is not the path's)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(".")[0] for w in caught
                   if "deterministic" in str(w.message)})


def phase_determinism(nr_module, train_mod, g2s_module, runner_mod, stack, make_sample,
                      dataset_cls, make_deterministic):
    phase(f"determinism: two identical {DET_STEPS}-step trainings on the card, bitwise "
          "(NeuralRecon small block config; each Gan2Shape mode, hard raster)")
    set_tf32(cudnn=True, matmul=False)   # PyTorch's defaults, as a user runs
    make_deterministic()                 # as the runners and the CLIs do
    frags = []
    for k, pair in enumerate(((0, 1), (2, 3))):
        b = stack([make_sample(seed=s, n_views=3, img_size=(64, 64), n_vox=32,
                               voxel_size=0.08, device="cuda") for s in pair])
        b["scene_reset"] = np.full(2, 1.0 if k == 0 else 0.0, np.float32)
        frags.append(b)

    def nr_run(probe=False):
        fw = nr_module.NeuralRecon(BLOCK_CFGS)
        st = [train_mod.init_train_state(fw, 0, frags[0], ADAM, CLIP)]

        def step(k):
            st[0], _ = train_mod.train_step(fw, st[0], frags[min(k, 1)])
        for k in range(DET_STEPS):
            step(k)
        out = {f"param.{n}": p.detach().clone() for n, p in st[0].net.named_parameters()}
        out.update({f"hidden.{i}": v.clone() for i, v in
                    enumerate(st[0].model_state["global_hidden"].volumes)})
        return out, (_nondeterministic_ops(lambda: step(1)) if probe else None)

    def g2s_run(mode, probe=False):
        data = dataset_cls(n_samples=1, image_size=32, z_dim=32).setup_input(0)
        fw = g2s_module.Gan2Shape(G2S_TRAIN_SMALL_CFG)
        cpu_fw = g2s_module.Gan2Shape(G2S_TRAIN_SMALL_CFG, device="cpu")
        undo = _host_drawn(fw, cpu_fw, 11)
        r = runner_mod.Gan2ShapeRunner(fw, G2S_ADAM, stage_iters=G2S_SMALL_FIT, num_stage=1)
        net, _ = r.setup(data)
        dev = fw.batch_to_device(data)
        b2 = dict(dev, **r._collect_canon(dev))
        proj, mask = r._collect_pool(b2)
        batch = dict(step1=dev, step2=b2,
                     step3=dict(dev, proj_im=proj[:4], proj_mask=mask[:4]))[mode]
        for _ in range(DET_STEPS):
            r.train_step(mode, batch)
        out = {n: p.detach().clone() for n, p in net.named_parameters()}
        ops = _nondeterministic_ops(lambda: r.train_step(mode, batch)) if probe else None
        undo()
        return out, ops

    results, probes = {}, {}
    for name, run in [("neuralrecon", nr_run)] + [
            (f"gan2shape_{m}", lambda probe=False, m=m: g2s_run(m, probe)) for m in G2S_MODES]:
        a, probes[name] = run(probe=True)
        b, _ = run()
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        results[name] = (len(a), differ)
        print(f"determinism {name}: {len(a)} tensors after {DET_STEPS} steps, "
              f"{len(differ)} differ between two runs {differ[:3]}; ops without a "
              f"deterministic implementation (use_deterministic_algorithms probe): "
              f"{probes[name] or 'none'}", flush=True)
    for name, (n, differ) in results.items():
        check(not differ, f"{name}: two identical trainings differ at {differ[:5]}")


# ---------------------------------------------------------------- phase 14 --
CLI_FRAMES = 36            # 4 fragments of 9 keyframes at 480x640
CLI_LOG_INTERVAL = 50      # no logging iteration inside the epoch


def _cli_config(datapath, work_dir, model_cfgs, n_views, img_hw, n_vox, voxel_size,
                epochs, checkpoint_interval, log_interval, lr_config=None,
                custom_hooks=()):
    """A NeuralRecon config file in the shape of configs/neural_recon/ and
    tools/quality_regression.py:40-94, the quality pipeline at ``img_hw``."""
    h, w = img_hw
    return f"""
pipeline = [
    dict(type="SeqResizeImage", size=({w}, {h}), depth_key="depth"),
    dict(type="SeqRandomTransformSpace", voxel_dim=({n_vox}, {n_vox}, {n_vox}),
         voxel_size={voxel_size}, random_rotation=False, random_translation=False,
         n_layers=3),
    dict(type="SeqIntrinsicsPoseToProjection", n_views={n_views}, stride=4),
    dict(type="SeqNormalizeImages", mean=[127.5] * 3, std=[127.5] * 3),
]
work_dir = {work_dir!r}
data = dict(
    samples_per_gpu=1,
    train=dict(type="ScanNetDataset", datapath={datapath!r}, mode="train",
               nviews={n_views}, n_scales=2, img_size=({w}, {h}), n_vox={n_vox},
               voxel_size={voxel_size}, pipeline=pipeline),
    test=dict(type="ScanNetDataset", datapath={datapath!r}, mode="test",
              nviews={n_views}, n_scales=2, img_size=({w}, {h}), n_vox={n_vox},
              voxel_size={voxel_size}, pipeline=pipeline),
)
model = dict(type="NeuralRecon", model_cfgs={dict(model_cfgs, save_scene=True)!r})
checkpoint_config = dict(interval={checkpoint_interval})
log_config = dict(interval={log_interval}, hooks=[dict(type="TextLoggerHook")])
optimizer_config = dict(grad_clip=dict(max_norm=1.0))
lr_config = {lr_config!r}
workflow = [("train", 1)]
runner = dict(type="EpochBasedRunner", runner_cfgs=dict(
    optimizer=dict(type="Adam", lr=1e-3, betas=(0.9, 0.999), weight_decay=0.0),
    max_epochs={epochs}))
custom_hooks = {list(custom_hooks)!r}
"""


def _fixture(write_fixture, data_gen, root, n_views, **kw):
    """The fixture scene in ScanNet's layout (train and test splits) and the
    port's data-gen over it; every frame is a keyframe."""
    t0 = time.perf_counter()
    write_fixture(root, splits=("train", "test"), device="cuda", **kw)
    for mode in ("train", "test"):
        data_gen.main(["--datapath", root, "--mode", mode, "--n-views", str(n_views),
                       "--min-angle", "1", "--min-distance", "0.01", "--n-proc", "1"])
    return time.perf_counter() - t0


def _timed_evaluate(scannet_mod):
    """Wraps ``ScanNetDataset.evaluate`` to record its wall seconds."""
    orig, took = scannet_mod.ScanNetDataset.evaluate, []

    def timed(self, *a, **kw):
        t0 = time.perf_counter()
        out = orig(self, *a, **kw)
        took.append(time.perf_counter() - t0)
        return out
    scannet_mod.ScanNetDataset.evaluate = timed
    return took, lambda: setattr(scannet_mod.ScanNetDataset, "evaluate", orig)


def phase_cli_full_width(fused_loss, train_mod, card, work, bare_step_ms, tools, hooks_mod,
                         scannet_mod, native, write_fixture, checkpoint_mod):
    phase("CLIs at full width: 480x640 fixture, data-gen, train (bench.py config, "
          "ScanNetDataset, 96^3, 1 epoch), test + evaluate")
    set_tf32(cudnn=True, matmul=False)   # PyTorch's defaults
    root, wd = os.path.join(work, "data"), os.path.join(work, "train")
    fix_s = _fixture(write_fixture, tools.data_gen_scannet, root, N_VIEWS,
                     n_frames=CLI_FRAMES, n_vox=N_VOX, voxel_size=0.04, img_size=IMG_HW)
    probe = {}

    @hooks_mod.HOOKS.register_module(force=True)
    class ChipSmokeProbe(hooks_mod.Hook):
        """Per step: synced wall time, fused-loss launches, the host gap
        before it; one step (not a logging one) under sync debug mode."""
        PRIORITY = 1

        def before_run(self, runner):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            probe.update(step_ms=[], launches=[], gap_ms=[], t=time.perf_counter())

        def before_train_iter(self, runner):
            torch.cuda.synchronize()
            now = time.perf_counter()
            probe["gap_ms"].append((now - probe["t"]) * 1e3)
            probe["t"], probe["l0"] = now, (fused_loss.launches, fused_loss.bwd_launches)
            if runner.inner_iter == 1:
                torch.cuda.set_sync_debug_mode("error")

        def after_train_iter(self, runner):
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            now = time.perf_counter()
            probe["step_ms"].append((now - probe["t"]) * 1e3)
            probe["launches"].append((fused_loss.launches - probe["l0"][0],
                                      fused_loss.bwd_launches - probe["l0"][1]))
            probe["t"] = now

        def after_run(self, runner):
            probe["peak"] = torch.cuda.max_memory_allocated()

    cfg = os.path.join(work, "cfg_full_width.py")
    with open(cfg, "w") as f:
        f.write(_cli_config(root, wd, BENCH_CFGS, N_VIEWS, IMG_HW, N_VOX, 0.04, epochs=1,
                            checkpoint_interval=1, log_interval=CLI_LOG_INTERVAL,
                            custom_hooks=[dict(type="ChipSmokeProbe")]))
    t0 = time.perf_counter()
    fused_loss.launches = fused_loss.bwd_launches = 0   # the main path starts here
    runner = tools.train.main([cfg])
    launches = (fused_loss.launches, fused_loss.bwd_launches)   # ... and ends here
    train_s = time.perf_counter() - t0
    n_steps = len(probe["step_ms"])
    check(launches == (3 * n_steps, 3 * n_steps), f"fused loss launches {launches}")
    check(n_steps == CLI_FRAMES // N_VIEWS, f"{n_steps} train steps, expected "
          f"{CLI_FRAMES // N_VIEWS}")
    check(probe["launches"] == [(3, 3)] * n_steps,
          f"fused loss (forward, backward) launches per step {probe['launches']}")
    ckpt = checkpoint_mod.latest_checkpoint(wd)
    check(ckpt is not None and ckpt.endswith(f"ckpt_{n_steps}")
          and os.path.exists(os.path.join(ckpt, "state.pt")), f"checkpoint {ckpt}")
    check(runner.state.step == n_steps, f"runner at step {runner.state.step}")
    # the bare train_step (phase 10's measure) on this run's own batches and
    # state, to hold the runner's step against the same work
    bare_ms = []
    for batch in runner.prefetch(runner.cur_loader):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        runner.state, _ = train_mod.train_step(runner.framework, runner.state, batch)
        torch.cuda.synchronize()
        bare_ms.append((time.perf_counter() - t1) * 1e3)
    # loader: one sample built from disk (9 PNG frames decoded, GT pyramid
    # fused on the card), synced
    ds = runner.cur_loader.dataset
    load_ms = []
    for i in range(len(ds)):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ds[i]
        torch.cuda.synchronize()
        load_ms.append((time.perf_counter() - t1) * 1e3)

    check(native.available(), "the host C++ op (ops/csrc/native.cpp) did not build")
    took, restore = _timed_evaluate(scannet_mod)
    t1 = time.perf_counter()
    res = tools.test.main([cfg, "--checkpoint", "auto", "--out",
                           os.path.join(work, "meshes"), "--eval", "depth_mesh"])
    test_s = time.perf_counter() - t1
    restore()
    check(isinstance(res, dict) and np.isfinite(res.get("fscore", np.nan)),
          f"evaluate returned {res}")
    print(f"cli_full_width: card={card!r} fixture_and_data_gen_s={fix_s:.3f} "
          f"train_cli_s={train_s:.3f} steps={n_steps} "
          f"runner_step_ms_median={statistics.median(probe['step_ms']):.6f} "
          f"runner_step_ms_max={max(probe['step_ms']):.6f} "
          f"runner_step_ms={[round(v, 3) for v in probe['step_ms']]} "
          f"bare_train_step_ms_median_phase10={bare_step_ms:.6f} "
          f"bare_train_step_ms_same_batches={[round(v, 3) for v in bare_ms]} "
          f"loader_ms_per_sample_median={statistics.median(load_ms):.6f} "
          f"loader_ms_per_sample_max={max(load_ms):.6f} "
          f"host_gap_ms_before_step={[round(v, 3) for v in probe['gap_ms']]} "
          f"fused_loss_launches_per_step={probe['launches'][0]} "
          f"max_memory_allocated_bytes={probe['peak']} checkpoint={os.path.basename(ckpt)} "
          f"test_cli_s={test_s:.3f} evaluate_s_per_scene={took[0]:.3f} "
          f"native_cpp=True", flush=True)
    print(f"cli_full_width evaluate (trained {n_steps} steps): {res}", flush=True)
    print("host syncs: none in the runner's step 2 (set_sync_debug_mode('error'), "
          "not a logging iteration)", flush=True)
    return launches


# ---------------------------------------------------------------- phase 15 --
# tools/quality_regression.py:40-94's model and pipeline, its fixture scene
# (write_scannet_fixture, 10 frames at 48x64, 5-view fragments) and its
# condition (:171-172); the port's fixture stores the colour frames as PNG
QUALITY_CFGS = dict(N_LAYER=3, N_VOX=[24, 24, 24], VOXEL_SIZE=0.08,
                    TRAIN_NUM_SAMPLE=[512, 2048, 8192],
                    BACKBONE2D=dict(ARC="fpn-mnas-0.5", INFER_MODE="batch"),
                    FUSION=dict(FUSION_ON=True, FULL=True), LW=[1.0, 0.8, 0.64],
                    THRESHOLDS=[0, 0, 0], POS_WEIGHT=1.5)
QUALITY_EPOCHS = 120


def phase_learning(card, work, tools, write_fixture):
    phase(f"learning check: tools/quality_regression.py's config through the CLIs, "
          f"{QUALITY_EPOCHS} epochs")
    set_tf32(cudnn=True, matmul=False)
    root, wd = os.path.join(work, "qdata"), os.path.join(work, "qtrain")
    _fixture(write_fixture, tools.data_gen_scannet, root, 5, n_frames=10)
    cfg = os.path.join(work, "cfg_quality.py")
    with open(cfg, "w") as f:
        f.write(_cli_config(root, wd, QUALITY_CFGS, 5, (48, 64), 24, 0.08,
                            epochs=QUALITY_EPOCHS, checkpoint_interval=40, log_interval=20,
                            lr_config=dict(policy="step", gamma=0.5, step=[60, 90])))
    t0 = time.perf_counter()
    un = tools.test.main([cfg, "--out", os.path.join(work, "qmeshes_untrained"),
                          "--eval", "depth_mesh"])
    runner = tools.train.main([cfg])
    tr = tools.test.main([cfg, "--out", os.path.join(work, "qmeshes_trained"),
                          "--eval", "depth_mesh", "--checkpoint", "auto"])
    took = time.perf_counter() - t0
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "QUALITY_r05.json")) as f:
        ref = json.load(f)
    # an untrained mesh that covers no GT pixel has no depth metrics (NaN):
    # it counts as worse than any defined AbsRel
    absrel_lower = tr["AbsRel"] < un["AbsRel"] or (
        bool(np.isnan(un["AbsRel"])) and bool(np.isfinite(tr["AbsRel"])))
    ok = tr["fscore"] > un["fscore"] + 0.05 and absrel_lower
    keys = ("fscore", "prec", "recal", "AbsRel", "complete")
    print(f"learning: card={card!r} epochs={runner.epoch} steps={runner.state.step} "
          f"phase_s={took:.3f} "
          + " ".join(f"trained_{k}={tr[k]!r} untrained_{k}={un[k]!r}" for k in keys)
          + " | QUALITY_r05.json (the JAX package on the CPU, quality numbers): "
          + " ".join(f"trained_{k}={ref['trained_fusion'][k]!r} "
                     f"untrained_{k}={ref['untrained_fusion'][k]!r}" for k in keys)
          + f" | learns_reconstruction={ok}", flush=True)
    check(ok, f"the trained model does not beat the untrained one: {tr} vs {un}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile the full-width NeuralRecon stream, its "
                         "training step, Gan2Shape forward_test and each "
                         "Gan2Shape training mode into DIR")
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
    from deep3dmap_tpu_torch.runners import train_state as train_mod

    import deep3dmap_tpu_torch.core.renderer.renderer_nr as renderer_mod
    import deep3dmap_tpu_torch.models.frameworks.gan2shape as g2s_module
    from deep3dmap_tpu_torch.datasets.gan_faces import SyntheticGanFaceDataset
    from deep3dmap_tpu_torch.ops import _cuda, raster
    from deep3dmap_tpu_torch.runners import gan2shape_runner as g2s_runner

    import deep3dmap_tpu_torch.datasets.scannet as scannet_mod
    import deep3dmap_tpu_torch.runners.checkpoint as checkpoint_mod
    import deep3dmap_tpu_torch.runners.hooks as hooks_mod
    import deep3dmap_tpu_torch.tools.data_gen_scannet  # noqa: F401
    import deep3dmap_tpu_torch.tools.test  # noqa: F401
    import deep3dmap_tpu_torch.tools.train  # noqa: F401
    from deep3dmap_tpu_torch import tools
    from deep3dmap_tpu_torch.datasets.synthetic import write_scannet_fixture
    from deep3dmap_tpu_torch.ops import native
    from deep3dmap_tpu_torch.utils.device import make_deterministic

    t0 = time.perf_counter()
    loss = phase_kernel_vs_plain(fused_loss)
    loss_bwd = phase_loss_bwd(fused_loss)
    phase_cpu_vs_card(nr_module, _stack_samples, make_fragment_sample)
    phase_train_cpu_vs_card(nr_module, train_mod, _stack_samples,
                            make_fragment_sample)
    launches = phase_full_width(nr_module, fused_loss, _stack_samples,
                                make_fragment_sample, card, args.profile)
    bwd = phase_train_full_width(nr_module, fused_loss, train_mod,
                                 _stack_samples, make_fragment_sample, card,
                                 make_deterministic, args.profile)
    raster_err = phase_raster(raster, renderer_mod, _cuda)
    phase_g2s_cpu_vs_card(g2s_module, SyntheticGanFaceDataset)
    g2s = phase_g2s_full_width(g2s_module, raster, SyntheticGanFaceDataset,
                               card, args.profile)
    phase_g2s_train_cpu_vs_card(g2s_module, g2s_runner, raster, SyntheticGanFaceDataset)
    g2s_train = phase_g2s_train_full_width(g2s_module, g2s_runner, raster,
                                           SyntheticGanFaceDataset, card, args.profile)
    phase_determinism(nr_module, train_mod, g2s_module, g2s_runner, _stack_samples,
                      make_fragment_sample, SyntheticGanFaceDataset, make_deterministic)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        cli_launches = phase_cli_full_width(
            fused_loss, train_mod, card, work, bwd["step_ms_median"], tools, hooks_mod,
            scannet_mod, native, write_scannet_fixture, checkpoint_mod)
        phase_learning(card, work, tools, write_scannet_fixture)
    print(f"phases took {time.perf_counter() - t0:.3f} s", flush=True)

    print(json.dumps({"kernels": [{
        "name": "fused_tsdf_occ_loss",
        "route": "triton",
        "source": "deep3dmap_tpu_torch/ops/fused_loss.py",
        "replaces": "deep3dmap_tpu/ops/pallas_loss.py:32",
        "launches": launches + cli_launches[0],
        "max_abs_err": loss["max_abs_err"],
        "ms": loss["ms"],
        "plain_ms": loss["plain_ms"],
        "bound_ms": loss["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "fused_tsdf_occ_loss_bwd",
        "route": "triton",
        "source": "deep3dmap_tpu_torch/ops/fused_loss.py",
        "replaces": "deep3dmap_tpu/ops/pallas_loss.py:112",
        "launches": bwd["launches"] + cli_launches[1],
        "max_abs_err": max(loss_bwd["max_abs_err"], bwd["max_abs_err"]),
        "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "raster_grid_depth_hard",
        "route": "cuda",
        "source": "deep3dmap_tpu_torch/ops/csrc/raster_hard.cu",
        "replaces": "deep3dmap_tpu/ops/raster_pallas.py:76",
        "launches": g2s["launches"] + g2s_train["launches"],
        "max_abs_err": max(raster_err, g2s["max_abs_err"], g2s_train["max_abs_err"]),
        "ms": g2s["ms"],
        "plain_ms": g2s["plain_ms"],
        "bound_ms": g2s["bound_ms"],
        "bound_by": g2s["bound_by"],
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
