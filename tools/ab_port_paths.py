#!/usr/bin/env python3
"""A/B of the PyTorch port's host-bound entry points across checkouts, on
one CUDA card.

    python3 tools/ab_port_paths.py ROOT [ROOT ...]           # serving
    python3 tools/ab_port_paths.py --train ROOT [ROOT ...]   # training

Each ROOT is a checkout (or a ``git archive``) holding
``deep3dmap_tpu_torch/`` and its ``chip_smoke.py``.  The roots run in the
order given, each in a fresh process that imports the port from that root
alone, so give them in turns (A B B A) and compare within one call.  Per
root it measures, with ``chip_smoke.py``'s configurations and seeds:

- Gan2Shape ``forward_test`` at celeba width, hard raster, B = 1: the
  median and max of ``--calls`` synced calls, and device ops and device
  time per call (torch.profiler over 3 calls);
- NeuralRecon ``val_fn`` at the bench config (after 2 fragments of
  ``forward_test``): the median and max of ``--val-calls`` synced calls,
  and device ops and device time per call (torch.profiler over 1 call).

With ``--train``, per root instead, with the cuDNN flags that root's
runners set (``utils/device.py::make_deterministic`` where it exists):

- NeuralRecon ``train_step`` at the bench config (``chip_smoke.py`` phase
  10: clip + Adam, fragment pinned on the card, state carried): 2 warm-up
  steps, then the median and max of ``--steps`` synced steps, and device
  ops and device time per step (torch.profiler over 2 steps);
- Gan2Shape ``Gan2ShapeRunner.train_step`` per mode at celeba width, hard
  raster (phase 12): the same per mode (the profiler over 3 steps).

It prints one JSON line per root, then the card's name and power limit.
Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def _device_ops(call, n):
    """(device ops, device ms) per call of ``call``: kernels and memsets
    that torch.profiler sees over ``n`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.count for e in ev) / n,
            sum(e.self_device_time_total for e in ev) / n / 1e3)


def _synced_ms(call, n):
    import torch
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out), max(out)


def worker(root: str, calls: int, val_calls: int) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    import deep3dmap_tpu_torch
    from deep3dmap_tpu_torch.datasets.builder import _stack_samples
    from deep3dmap_tpu_torch.datasets.gan_faces import SyntheticGanFaceDataset
    from deep3dmap_tpu_torch.datasets.synthetic import make_fragment_sample
    from deep3dmap_tpu_torch.models.frameworks.gan2shape import Gan2Shape
    from deep3dmap_tpu_torch.models.frameworks.neuralrecon import NeuralRecon

    assert os.path.dirname(os.path.dirname(
        os.path.abspath(deep3dmap_tpu_torch.__file__))) == root
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"root": root}

    data = SyntheticGanFaceDataset(n_samples=1, image_size=128,
                                   z_dim=512).setup_input(0)
    fw = Gan2Shape(cs.CELEBA_MODEL_CFGS)
    net, state = fw.init(0, data)
    batch = fw.batch_to_device(data)

    def g2s():
        fw.forward_test(net, state, batch)
    for _ in range(3):
        g2s()
    res["g2s_forward_test_ms_median"], res["g2s_forward_test_ms_max"] = \
        _synced_ms(g2s, calls)
    res["g2s_device_ops_per_call"], res["g2s_device_ms_per_call"] = \
        _device_ops(g2s, 3)
    del fw, net

    frag = _stack_samples([make_fragment_sample(
        seed=0, n_views=cs.N_VIEWS, img_size=cs.IMG_HW, n_vox=cs.N_VOX,
        voxel_size=0.04, device="cuda")])
    nr = NeuralRecon(cs.BENCH_CFGS)
    net, st = nr.init(0, frag)
    dev = nr.batch_to_device(frag)
    first = dict(dev, scene_reset=torch.ones(1, device=nr.device))
    cont = dict(dev, scene_reset=torch.zeros(1, device=nr.device))
    _, st = nr.forward_test(net, st, first)
    _, st = nr.forward_test(net, st, cont)

    def val():
        nr.val_fn(net, st, cont)
    val()
    res["val_fn_ms_median"], res["val_fn_ms_max"] = _synced_ms(val, val_calls)
    res["val_fn_device_ops_per_call"], res["val_fn_device_ms_per_call"] = \
        _device_ops(val, 1)
    loss = float(nr.val_fn(net, st, cont)["log_vars"]["loss"])
    assert np.isfinite(loss), loss
    res["val_loss"] = loss
    return res


def train_worker(root: str, steps: int) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import deep3dmap_tpu_torch
    import deep3dmap_tpu_torch.utils.device as device_mod
    from deep3dmap_tpu_torch.datasets.builder import _stack_samples
    from deep3dmap_tpu_torch.datasets.gan_faces import SyntheticGanFaceDataset
    from deep3dmap_tpu_torch.datasets.synthetic import make_fragment_sample
    from deep3dmap_tpu_torch.models.frameworks.gan2shape import Gan2Shape
    from deep3dmap_tpu_torch.models.frameworks.neuralrecon import NeuralRecon
    from deep3dmap_tpu_torch.runners import train_state
    from deep3dmap_tpu_torch.runners.gan2shape_runner import Gan2ShapeRunner

    assert os.path.dirname(os.path.dirname(
        os.path.abspath(deep3dmap_tpu_torch.__file__))) == root
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    deterministic = hasattr(device_mod, "make_deterministic")
    if deterministic:
        device_mod.make_deterministic()
    res = {"root": root, "make_deterministic": deterministic}

    frag = _stack_samples([make_fragment_sample(
        seed=0, n_views=cs.N_VIEWS, img_size=cs.IMG_HW, n_vox=cs.N_VOX,
        voxel_size=0.04, device="cuda")])
    nr = NeuralRecon(cs.BENCH_CFGS)
    st = [train_state.init_train_state(nr, 0, frag, cs.ADAM, cs.CLIP)]
    dev = nr.batch_to_device(frag)

    def nr_step():
        st[0], _ = train_state.train_step(nr, st[0], dev)
    for _ in range(2):
        nr_step()
    res["train_step_ms_median"], res["train_step_ms_max"] = _synced_ms(nr_step, steps)
    res["train_step_device_ops"], res["train_step_device_ms"] = _device_ops(nr_step, 2)
    del nr, st, dev

    data = SyntheticGanFaceDataset(n_samples=1, image_size=128, z_dim=512).setup_input(0)
    fw = Gan2Shape(cs.CELEBA_TRAIN_CFGS)
    r = Gan2ShapeRunner(fw, cs.G2S_ADAM, stage_iters=cs.G2S_FIT_ITERS, num_stage=1)
    net, state = r.setup(data)
    b1 = fw.batch_to_device(data)
    b2 = dict(b1, **r._collect_canon(b1))
    with torch.no_grad():
        _, _, o = fw.forward_step2(net, state, b2, r.rng)
    batches = dict(step1=b1, step2=b2, step3=dict(b1, proj_im=o["proj_im"],
                                                  proj_mask=o["mask"]))
    for mode in cs.G2S_MODES:
        def g2s_step():
            r.train_step(mode, batches[mode])
        for _ in range(2):
            g2s_step()
        res[f"g2s_{mode}_ms_median"], res[f"g2s_{mode}_ms_max"] = _synced_ms(g2s_step, steps)
        res[f"g2s_{mode}_device_ops"], res[f"g2s_{mode}_device_ms"] = _device_ops(g2s_step, 3)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--val-calls", type=int, default=5)
    ap.add_argument("--train", action="store_true",
                    help="time the training steps instead of the serving paths")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        root = os.path.abspath(a.roots[0])
        res = (train_worker(root, a.steps) if a.train
               else worker(root, a.calls, a.val_calls))
        print(json.dumps(res), flush=True)
        return
    for root in a.roots:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", "--calls", str(a.calls),
                              "--val-calls", str(a.val_calls),
                              "--steps", str(a.steps), *(["--train"] if a.train else []),
                              os.path.abspath(root)],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            sys.exit(f"ab_port_paths: {root} failed:\n{out.stderr[-4000:]}")
        print(out.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
