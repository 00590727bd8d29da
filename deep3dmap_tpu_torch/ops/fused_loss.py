"""Fused masked TSDF/occupancy loss: a Triton kernel for Hopper.

Replaces the Pallas TPU kernel ``deep3dmap_tpu/ops/pallas_loss.py``
(``_fwd_kernel``, reached through ``_partial_sums`` and
``fused_tsdf_occ_loss``).  It streams five same-shape volumes once -- tsdf
prediction ``t``, occupancy logit ``x``, tsdf target ``tt``, occupancy target
``y`` and mask ``m`` -- and returns five float32 sums:

    [Σm, Σm·y, Σm·y·(−logσx), Σm·(1−y)·(−logσ(−x)), Σm·y·|slog t − slog tt|]

with slog(t) = sign(t)·log(|t| + 1).  ``_combine`` turns them into
(total, occ_loss, tsdf_loss) with the dynamic positive weight, as plain tensor
ops on the device (no host sync).

Bound on an H100: the work is a few dozen flops per element, so reading the
five volumes bounds it.  At 96³ with f32 predictions and targets and a bool
mask that is 884,736 × 17 B ≈ 15 MB, about 4.5 µs at 3.35 TB/s; at the
24³/48³ levels the kernel is launch-bound.

Design, not carried over from the TPU.  The TPU wrapper pads and casts every
input into a fresh f32 array and walks one sequential grid that accumulates in
SMEM.  Here:
  * each program reads the inputs in their own dtypes (bf16 or f32
    predictions, bool/uint8 or f32 targets and mask), converts them in
    registers and masks the ragged tail itself -- no padded copies;
  * stage 1 runs at most ``_MAX_PROGRAMS`` programs, each looping over tiles
    of ``_BLOCK`` elements and writing its 5 partial sums to a
    ``(n_programs, 8)`` f32 buffer -- no float atomics;
  * stage 2 is one program that reduces that buffer in a fixed order, so a
    run is bitwise repeatable.
A CUDA tensor always launches the kernel and a failure raises; CPU tensors
take ``fused_tsdf_occ_loss_plain``.  ``launches`` counts kernel launches (one
per call that launches the two stages).

The backward (``pallas_loss.py:112-139``) is training's and is not here yet.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

_BLOCK = 2048          # elements per tile (16 per thread at 4 warps)
_MAX_PROGRAMS = 528    # 4 resident programs on each of the H100's 132 SMs

launches = 0           # kernel launches since the last reset


def _slog(t: torch.Tensor) -> torch.Tensor:
    return torch.sign(t) * torch.log(torch.abs(t) + 1.0)


def partial_sums_plain(tsdf, occ, tsdf_t, occ_t, mask) -> torch.Tensor:
    """The five sums in plain PyTorch, float32, shape (5,)."""
    t, x, tt, y, m = (a.float() for a in (tsdf, occ, tsdf_t, occ_t, mask))
    my = m * y
    return torch.stack([
        m.sum(),
        my.sum(),
        (my * -F.logsigmoid(x)).sum(),
        (m * (1.0 - y) * -F.logsigmoid(-x)).sum(),
        (my * torch.abs(_slog(t) - _slog(tt))).sum(),
    ])


def _combine(sums: torch.Tensor, pos_weight: float):
    n_all, n_p = sums[0], sums[1]
    w1 = torch.where(n_p > 0, (n_all - n_p) / torch.clamp(n_p, min=1.0),
                     torch.zeros_like(n_p)) * pos_weight
    occ_loss = (w1 * sums[2] + sums[3]) / torch.clamp(n_all, min=1.0)
    tsdf_loss = sums[4] / torch.clamp(n_p, min=1.0)
    total = torch.where(n_p > 0, occ_loss + tsdf_loss,
                        torch.zeros_like(occ_loss))
    return total, occ_loss, tsdf_loss


def fused_tsdf_occ_loss_plain(tsdf, occ, tsdf_t, occ_t, mask,
                              pos_weight: float = 1.0):
    """Plain-PyTorch version of ``fused_tsdf_occ_loss`` (stable log-sigmoid).
    Returns (total, occ_loss, tsdf_loss)."""
    return _combine(partial_sums_plain(tsdf, occ, tsdf_t, occ_t, mask),
                    pos_weight)


@functools.lru_cache(maxsize=None)
def _kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def sums_kernel(t_ptr, x_ptr, tt_ptr, y_ptr, m_ptr, part_ptr, n,
                    tiles_per_prog, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        nprog = tl.num_programs(0)
        s_m = tl.zeros([BLOCK], tl.float32)
        s_my = tl.zeros([BLOCK], tl.float32)
        s_pos = tl.zeros([BLOCK], tl.float32)
        s_neg = tl.zeros([BLOCK], tl.float32)
        s_t = tl.zeros([BLOCK], tl.float32)
        for it in range(0, tiles_per_prog):
            offs = (pid + it * nprog) * BLOCK + tl.arange(0, BLOCK)
            inb = offs < n
            t = tl.load(t_ptr + offs, mask=inb, other=0).to(tl.float32)
            x = tl.load(x_ptr + offs, mask=inb, other=0).to(tl.float32)
            tt = tl.load(tt_ptr + offs, mask=inb, other=0).to(tl.float32)
            y = tl.load(y_ptr + offs, mask=inb, other=0).to(tl.float32)
            m = tl.load(m_ptr + offs, mask=inb, other=0).to(tl.float32)
            # stable: -logσ(x) = max(-x, 0) + log(1 + e^-|x|), and
            #         -logσ(-x) = max(x, 0) + log(1 + e^-|x|)
            soft = tl.log(1.0 + tl.exp(-tl.abs(x)))
            sgn_t = tl.where(t > 0, 1.0, tl.where(t < 0, -1.0, 0.0))
            sgn_tt = tl.where(tt > 0, 1.0, tl.where(tt < 0, -1.0, 0.0))
            lt = sgn_t * tl.log(tl.abs(t) + 1.0)
            ltt = sgn_tt * tl.log(tl.abs(tt) + 1.0)
            my = m * y
            s_m += m
            s_my += my
            s_pos += my * (tl.maximum(-x, 0.0) + soft)
            s_neg += m * (1.0 - y) * (tl.maximum(x, 0.0) + soft)
            s_t += my * tl.abs(lt - ltt)
        row = part_ptr + pid * 8
        tl.store(row + 0, tl.sum(s_m, axis=0))
        tl.store(row + 1, tl.sum(s_my, axis=0))
        tl.store(row + 2, tl.sum(s_pos, axis=0))
        tl.store(row + 3, tl.sum(s_neg, axis=0))
        tl.store(row + 4, tl.sum(s_t, axis=0))

    @triton.jit
    def final_kernel(part_ptr, out_ptr, nprog, NP: tl.constexpr):
        rows = tl.arange(0, NP)
        cols = tl.arange(0, 8)
        ok = (rows[:, None] < nprog) & (cols[None, :] < 5)
        p = tl.load(part_ptr + rows[:, None] * 8 + cols[None, :], mask=ok,
                    other=0.0)
        tl.store(out_ptr + cols, tl.sum(p, axis=0), mask=cols < 5)

    return triton, sums_kernel, final_kernel


def _flat_for_kernel(a: torch.Tensor) -> torch.Tensor:
    if not a.is_contiguous():
        raise ValueError("fused_tsdf_occ_loss: inputs must be contiguous")
    a = a.reshape(-1)
    if a.dtype == torch.bool:
        a = a.view(torch.uint8)   # same bytes; triton loads it as u8
    if a.dtype not in (torch.float32, torch.bfloat16, torch.float16,
                       torch.uint8):
        raise TypeError(f"fused_tsdf_occ_loss: unsupported dtype {a.dtype}")
    return a


def partial_sums_cuda(tsdf, occ, tsdf_t, occ_t, mask) -> torch.Tensor:
    """The five sums from the Triton kernel, float32, shape (5,)."""
    global launches
    ins = [_flat_for_kernel(a) for a in (tsdf, occ, tsdf_t, occ_t, mask)]
    n = ins[0].numel()
    if n >= 2 ** 31 - _BLOCK * _MAX_PROGRAMS:
        raise ValueError("fused_tsdf_occ_loss: too many elements for int32 offsets")
    triton, sums_kernel, final_kernel = _kernels()
    n_tiles = triton.cdiv(n, _BLOCK)
    nprog = max(1, min(n_tiles, _MAX_PROGRAMS))
    tiles_per_prog = triton.cdiv(n_tiles, nprog)
    dev = ins[0].device
    part = torch.empty((nprog, 8), device=dev, dtype=torch.float32)
    out = torch.empty((8,), device=dev, dtype=torch.float32)
    sums_kernel[(nprog,)](*ins, part, n, tiles_per_prog, BLOCK=_BLOCK,
                          num_warps=4)
    final_kernel[(1,)](part, out, nprog,
                       NP=max(16, triton.next_power_of_2(nprog)), num_warps=4)
    launches += 1
    return out[:5]


def fused_tsdf_occ_loss(tsdf, occ, tsdf_t, occ_t, mask, pos_weight: float = 1.0):
    """Fused masked loss; returns (total, occ_loss, tsdf_loss) as 0-d tensors.

    All five inputs have one shape.  CUDA tensors launch the Triton kernel;
    CPU tensors take the plain version.
    """
    args = (tsdf, occ, tsdf_t, occ_t, mask)
    shape = tsdf.shape
    if any(a.shape != shape for a in args):
        raise ValueError(f"fused_tsdf_occ_loss: shapes differ: "
                         f"{[tuple(a.shape) for a in args]}")
    devs = {a.device.type for a in args}
    if devs == {"cpu"}:
        return fused_tsdf_occ_loss_plain(*args, pos_weight=pos_weight)
    if devs != {"cuda"}:
        raise ValueError(f"fused_tsdf_occ_loss: inputs on {sorted(devs)}; "
                         "all must be on one CUDA device or all on the CPU")
    return _combine(partial_sums_cuda(*args), pos_weight)
