#!/usr/bin/env python3
"""Device time of source variants of the hard raster kernel, on one CUDA card.

    python3 tools/ab_raster_variants.py

Builds ``deep3dmap_tpu_torch/ops/csrc/raster_hard.cu`` as it is and with a
few text edits (threads per triangle, the box's one-pixel margin, the pixel
tests cut out), all ``nvcc`` builds at once into
``deep3dmap_tpu_torch/ops/_build/variants/``.  Each variant runs on
``chip_smoke.py``'s seeded celeba views (128², B = 1 and 4) and must equal
the plain version bit for bit (but the setup-only one, which tests no
pixel).  Prints each variant's device time per call by device op
(``chip_smoke.device_ops_ms``), in two rounds of opposite order, then the
card's name and power limit.  Imports no JAX.
"""
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs                                          # noqa: E402
import deep3dmap_tpu_torch.core.renderer.renderer_nr as rmod      # noqa: E402
from deep3dmap_tpu_torch.ops import _cuda, raster                # noqa: E402

LANES4 = "constexpr int kLanes = 4;"
MARGIN = [("floorf(__fsub_rn(cmin, u)) - 1.0f", "floorf(__fsub_rn(cmin, u))"),
          ("ceilf(__fadd_rn(cmax, u)) + 1.0f", "ceilf(__fadd_rn(cmax, u))")]
TESTS = ("  unsigned* out_b = out + (size_t)(t / (2 * (H - 1) * (W - 1))) * H * W;\n"
         "  int i = lane")
VARIANTS = {
    "as_is": [],
    "lanes1": [(LANES4, "constexpr int kLanes = 1;")],
    "lanes2": [(LANES4, "constexpr int kLanes = 2;")],
    "no_margin": MARGIN,
    "lanes1_no_margin": [(LANES4, "constexpr int kLanes = 1;")] + MARGIN,
    # the fast path without its pixel tests (n is never 12345 there)
    "lanes1_setup_only": [(LANES4, "constexpr int kLanes = 1;"),
                          (TESTS, "  if (n != 12345) return;\n" + TESTS)],
}


def build_all():
    out_dir = os.path.join(_cuda.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_cuda.CSRC, "raster_hard.cu")) as f:
        src = f.read()
    procs = {}
    for name, edits in VARIANTS.items():
        s = src
        for a, b in edits:
            assert a in s, f"{name}: the source no longer holds {a!r}"
            s = s.replace(a, b)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(s)
        procs[name] = subprocess.Popen(
            [_cuda.find_nvcc(), *_cuda.NVCC_FLAGS, "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            sys.exit(f"{name}: nvcc failed\n{log}")
        print(name, "ptxas:", " | ".join(ln.strip() for ln in log.splitlines()
                                         if "registers" in ln))
        fn = ctypes.CDLL(os.path.join(out_dir, f"{name}.so")).d3m_raster_grid_depth_hard
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_void_p]
        fns[name] = fn
    return fns


def launch(fn, pts, K, bg):
    B, H, W, _ = pts.shape
    out = torch.empty((B, H, W), device=pts.device)
    scratch = torch.empty((2 * B * (H - 1) * (W - 1) + 1,), device=pts.device,
                          dtype=torch.int32)
    err = fn(pts.data_ptr(), K.data_ptr(), out.data_ptr(),
             scratch.data_ptr() + 4, scratch.data_ptr(), B, H, W, float(bg),
             torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"CUDA error {err}"
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("ab_raster_variants: needs a CUDA GPU")
    fns = build_all()
    for B, seed in ((1, 0), (4, 1)):
        pts, K, bg = cs._celeba_views(rmod, B, seed)
        pts = pts.contiguous()
        want = raster.raster_grid_depth_hard_plain(pts, K, bg)
        sets = [(pts.clone(), K, bg) for _ in range(4)]
        for rnd, order in enumerate((list(fns), list(fns)[::-1])):
            for name in order:
                fn = fns[name]
                if name != "lanes1_setup_only":
                    assert torch.equal(launch(fn, pts, K, bg), want), name
                ops = cs.device_ops_ms(lambda p, k, b, fn=fn: launch(fn, p, k, b), sets)
                print(f"B={B} round={rnd} {name}: " + " ".join(
                    f"{k.split('::')[-1].split('(')[0]}={v * 1e3:.2f}us"
                    for k, v in sorted(ops.items()))
                    + f" total={sum(ops.values()) * 1e3:.2f}us", flush=True)
    print(cs.device_line())


if __name__ == "__main__":
    main()
