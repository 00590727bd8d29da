"""Fused masked TSDF/occupancy loss: one Triton kernel for Hopper.

Replaces the Pallas TPU kernel ``deep3dmap_tpu/ops/pallas_loss.py``
(``_fwd_kernel``, reached through ``_partial_sums`` and
``fused_tsdf_occ_loss``) and the combine after it.  It streams five
same-shape volumes once -- tsdf prediction ``t``, occupancy logit ``x``, tsdf
target ``tt``, occupancy target ``y`` and mask ``m`` -- into five float32
sums:

    [Σm, Σm·y, Σm·y·(−logσx), Σm·(1−y)·(−logσ(−x)), Σm·y·|slog t − slog tt|]

with slog(t) = sign(t)·log(|t| + 1), and turns them into (total, occ_loss,
tsdf_loss) with the dynamic positive weight, as ``_combine`` does.

Bound on an H100: the work is a few dozen flops per element, so reading the
five volumes bounds it.  At 96³ with f32 predictions and targets and a bool
mask that is 884,736 × 17 B ≈ 15 MB, about 4.5 µs at 3.35 TB/s; at the
24³/48³ levels one launch's fixed cost bounds it.

Design, not carried over from the TPU.  The TPU wrapper pads and casts every
input into a fresh f32 array and walks one sequential grid that accumulates in
SMEM.  Here one launch does it all:
  * each program reads the inputs in their own dtypes (bf16 or f32
    predictions, bool/uint8 or f32 targets and mask), converts them in
    registers and masks the ragged tail itself -- no padded copies;
  * at most ``_MAX_PROGRAMS`` programs each loop over tiles of ``_BLOCK``
    elements and write their 5 partial sums to a ``(n_programs, 8)`` f32
    buffer -- no float atomics;
  * each program then takes a ticket (an int32 ``atomic_add`` with acq_rel
    semantics, after a block barrier, so its partials are visible first);
    the last one reads every partial past L1, reduces them in a fixed order,
    so a run is bitwise repeatable, computes the three losses in-kernel and
    resets the ticket to 0 for the next call.
The ticket is allocated and zeroed once per (device, stream), so calls on
one stream are ordered and never share it with another stream.  The last
program also writes the five sums beside the three losses, into one
8-float device tensor (a row of the backward's ``(L, 8)`` tensor): Σm and
Σm·y in floats 3-4, which the backward reads, the other three in 5-7.

Across ranks (``group=``, data parallelism): the loss divides by Σm and
Σm·y over the whole global batch, so a rank's own sums do not give it.
Each rank's forward launches stay as they are; then one ``all_reduce(SUM)``
of the ``(L, 5)`` raw sums per call (not per level), ``_combine`` on the
global sums in PyTorch, and the backward kernel fed the global Σm, Σm·y.
Each rank's gradient is then the global loss's through its own shard, and
summing the ranks' parameter gradients gives the global gradient
(``runners/train_state.py``).  In a group of one rank the all-reduce is the
identity and the losses stay the kernel's own, so the result is bit-equal
to no group.

Backward (replaces ``_bwd``, ``pallas_loss.py:112-139``, the custom VJP's
"second fused pass"): ``loss_bwd_kernel``, one elementwise Triton launch for
every level of a train step (up to ``_BWD_LEVELS``; more levels take one
launch per group).  It reads the five volumes in their own dtypes and writes
d_tsdf and d_occ in the predictions' dtypes; the sums (Σm, Σm·y) come from
the forward's ``(L, 8)`` device tensor (row i is level i's five floats) and
the cotangents from one ``(L, 3)`` tensor, so nothing leaves the device and
nothing is recomputed.  Bound on an H100: bytes.  Five loads and two stores
per element and no reduction: at NeuralRecon's 24³ + 48³ + 96³ levels with
float32 predictions and targets and a bool mask, 1,009,152 × 25 B ≈ 25.2 MB,
about 7.5 µs at 3.35 TB/s.  Design:
  * each level owns a contiguous range of programs; a program picks its
    level by comparing its id with the range starts (runtime scalars) and
    runs the same tile body on that level's pointers -- one launch, not one
    per level, whose fixed cost dominated the two small levels;
  * ``_BWD_BLOCK`` = 512 elements a program at ``_BWD_WARPS`` = 4 warps,
    4 elements a thread: each float32 input in one 16-byte load, a bool
    mask in one 4-byte load, all with ``evict_first``, the gradients stored
    streaming (``.cs``); 62 registers a thread, so many programs stay
    resident and their loads in flight.  Larger tiles give 16-byte loads to
    every dtype but cost registers (112 a thread at 8 elements, 211 at 16,
    spills at 32) and were slower on the card (``tools/ab_loss_bwd.py``);
  * the level's scalars w1, c_occ/n_all and c_tsdf/n_p are computed once per
    program, so an element multiplies where ``_bwd`` divides by the two
    sums; the sigmoid keeps its IEEE division (sig − 1 cancels near 1, so
    an ulp there would be visible) and the two logs stay, since sign(slog t
    − slog tt) is 0 where rounding makes them equal and sign(t − tt) is not;
  * every input is read in full: no load is skipped where the mask is 0.
Elementwise, so two calls give the same bits.

``fused_tsdf_occ_loss_levels`` is the ``torch.autograd.Function`` over L
levels (the forward kernel once per level, the backward kernel once, and
with a ``group`` one all-reduce between them);
``fused_tsdf_occ_loss`` is the same Function at L = 1.  CUDA tensors always
launch the kernels and a failure raises; CPU tensors take
``partial_sums_plain`` and ``fused_tsdf_occ_loss_bwd_plain`` per level.
The counters ``fused_loss.fwd_launches`` and ``fused_loss.bwd_launches``
(``utils/tracing.py``) count the forward and backward kernel launches.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..parallel import collectives
from ..utils import tracing

_BLOCK = 2048          # elements per tile (16 per thread at 4 warps)
_MAX_PROGRAMS = 528    # 4 resident programs on each of the H100's 132 SMs
# elements per backward program and its warps: 4 elements a thread, one
# 16-byte load of each float32 input; the best of the tile shapes that
# tools/ab_loss_bwd.py times (8 a thread take 112 registers, 16 take 211)
_BWD_BLOCK = 512
_BWD_WARPS = 4
_BWD_LEVELS = 3        # levels one backward launch takes (NeuralRecon's three)


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


def fused_tsdf_occ_loss_bwd_plain(tsdf, occ, tsdf_t, occ_t, mask, sums, g,
                                  pos_weight: float = 1.0):
    """``_bwd`` (``pallas_loss.py:112-139``) in plain PyTorch, op for op.

    ``sums`` holds (Σm, Σm·y) in float32; ``g`` the float32 cotangents of
    (total, occ_loss, tsdf_loss), shape (3,).  Returns (d_tsdf, d_occ) in the
    predictions' dtypes.  TRAP: at t == 0 this is sign(lt − ltt)/n_p where
    autodiff of the jnp loss gives 0 (sign'(0) = 0); the TPU computes this.
    """
    s_all, s_p = sums[0], sums[1]
    n_all = torch.clamp(s_all, min=1.0)
    n_p = torch.clamp(s_p, min=1.0)
    has_p = s_p > 0
    w1 = torch.where(has_p, (s_all - s_p) / n_p, torch.zeros_like(s_p)) * pos_weight
    c_occ = torch.where(has_p, g[0] + g[1], g[1])
    c_tsdf = torch.where(has_p, g[0] + g[2], g[2])
    m, y = mask.float(), occ_t.float()
    sig = torch.sigmoid(occ.float())
    d_occ = c_occ * m * (w1 * y * (sig - 1.0) + (1.0 - y) * sig) / n_all
    t, tt = tsdf.float(), tsdf_t.float()
    d_tsdf = (c_tsdf * m * y * torch.sign(_slog(t) - _slog(tt))
              / (torch.abs(t) + 1.0) / n_p)
    return d_tsdf.to(tsdf.dtype), d_occ.to(occ.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def loss_kernel(t_ptr, x_ptr, tt_ptr, y_ptr, m_ptr, part_ptr, ticket_ptr,
                    out_ptr, n, tiles_per_prog, pos_weight,
                    BLOCK: tl.constexpr, NP: tl.constexpr):
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
        # every thread's stores happen before the ticket's release
        tl.debug_barrier()
        done = tl.atomic_add(ticket_ptr, 1, sem="acq_rel", scope="gpu")
        if done == nprog - 1:
            # the last program: every partial is visible; read them past L1
            # and reduce each column in one fixed order
            rows = tl.arange(0, NP)
            live = rows < nprog
            n_all = tl.sum(tl.load(part_ptr + rows * 8 + 0, mask=live, other=0.0,
                                   cache_modifier=".cg"), axis=0)
            n_p = tl.sum(tl.load(part_ptr + rows * 8 + 1, mask=live, other=0.0,
                                 cache_modifier=".cg"), axis=0)
            s2 = tl.sum(tl.load(part_ptr + rows * 8 + 2, mask=live, other=0.0,
                                cache_modifier=".cg"), axis=0)
            s3 = tl.sum(tl.load(part_ptr + rows * 8 + 3, mask=live, other=0.0,
                                cache_modifier=".cg"), axis=0)
            s4 = tl.sum(tl.load(part_ptr + rows * 8 + 4, mask=live, other=0.0,
                                cache_modifier=".cg"), axis=0)
            # _combine, op for op (IEEE divisions, as PyTorch divides)
            w1 = tl.where(n_p > 0, tl.div_rn(n_all - n_p, tl.maximum(n_p, 1.0)),
                          0.0) * pos_weight
            occ_loss = tl.div_rn(w1 * s2 + s3, tl.maximum(n_all, 1.0))
            tsdf_loss = tl.div_rn(s4, tl.maximum(n_p, 1.0))
            total = tl.where(n_p > 0, occ_loss + tsdf_loss, 0.0)
            tl.store(out_ptr + 0, total)
            tl.store(out_ptr + 1, occ_loss)
            tl.store(out_ptr + 2, tsdf_loss)
            tl.store(out_ptr + 3, n_all)       # read by loss_bwd_kernel
            tl.store(out_ptr + 4, n_p)
            tl.store(out_ptr + 5, s2)          # all-reduced across ranks
            tl.store(out_ptr + 6, s3)
            tl.store(out_ptr + 7, s4)
            tl.atomic_xchg(ticket_ptr, 0, sem="relaxed", scope="gpu")

    @triton.jit
    def bwd_tile(t_ptr, x_ptr, tt_ptr, y_ptr, m_ptr, dt_ptr, dx_ptr, n, tile,
                 row_ptr, g_ptr, pos_weight, BLOCK: tl.constexpr):
        # _bwd on one tile of one level.  The level's scalars, once: w1 and
        # the cotangents over the sums, IEEE-divided as PyTorch divides
        s_all = tl.load(row_ptr + 3)
        s_p = tl.load(row_ptr + 4)
        g_total = tl.load(g_ptr + 0)
        g_occ = tl.load(g_ptr + 1)
        g_tsdf = tl.load(g_ptr + 2)
        n_p = tl.maximum(s_p, 1.0)
        has_p = s_p > 0
        w1 = tl.where(has_p, tl.div_rn(s_all - s_p, n_p), 0.0) * pos_weight
        k_occ = tl.div_rn(tl.where(has_p, g_total + g_occ, g_occ),
                          tl.maximum(s_all, 1.0))
        k_tsdf = tl.div_rn(tl.where(has_p, g_total + g_tsdf, g_tsdf), n_p)

        offs = tile * BLOCK + tl.arange(0, BLOCK)
        inb = offs < n
        t = tl.load(t_ptr + offs, mask=inb, other=0,
                    eviction_policy="evict_first").to(tl.float32)
        x = tl.load(x_ptr + offs, mask=inb, other=0,
                    eviction_policy="evict_first").to(tl.float32)
        tt = tl.load(tt_ptr + offs, mask=inb, other=0,
                     eviction_policy="evict_first").to(tl.float32)
        y = tl.load(y_ptr + offs, mask=inb, other=0,
                    eviction_policy="evict_first").to(tl.float32)
        m = tl.load(m_ptr + offs, mask=inb, other=0,
                    eviction_policy="evict_first").to(tl.float32)
        sig = tl.div_rn(1.0, 1.0 + tl.exp(-x))
        d_occ = k_occ * m * (w1 * y * (sig - 1.0) + (1.0 - y) * sig)
        sgn_t = tl.where(t > 0, 1.0, tl.where(t < 0, -1.0, 0.0))
        sgn_tt = tl.where(tt > 0, 1.0, tl.where(tt < 0, -1.0, 0.0))
        diff = sgn_t * tl.log(tl.abs(t) + 1.0) - sgn_tt * tl.log(tl.abs(tt) + 1.0)
        sgn = tl.where(diff > 0, 1.0, tl.where(diff < 0, -1.0, 0.0))
        d_tsdf = k_tsdf * m * y * sgn / (tl.abs(t) + 1.0)
        tl.store(dt_ptr + offs, d_tsdf.to(dt_ptr.dtype.element_ty), mask=inb,
                 cache_modifier=".cs")
        tl.store(dx_ptr + offs, d_occ.to(dx_ptr.dtype.element_ty), mask=inb,
                 cache_modifier=".cs")

    @triton.jit
    def loss_bwd_kernel(t0, x0, tt0, y0, m0, dt0, dx0, n0,
                        t1, x1, tt1, y1, m1, dt1, dx1, n1,
                        t2, x2, tt2, y2, m2, dt2, dx2, n2,
                        start1, start2, sums_ptr, row_stride, g_ptr, pos_weight,
                        BLOCK: tl.constexpr):
        # programs [0, start1) take level 0, [start1, start2) level 1, the
        # rest level 2; a level that is not there has an empty range
        pid = tl.program_id(0)
        if pid < start1:
            bwd_tile(t0, x0, tt0, y0, m0, dt0, dx0, n0, pid,
                     sums_ptr, g_ptr, pos_weight, BLOCK)
        elif pid < start2:
            bwd_tile(t1, x1, tt1, y1, m1, dt1, dx1, n1, pid - start1,
                     sums_ptr + row_stride, g_ptr + 3, pos_weight, BLOCK)
        else:
            bwd_tile(t2, x2, tt2, y2, m2, dt2, dx2, n2, pid - start2,
                     sums_ptr + 2 * row_stride, g_ptr + 6, pos_weight, BLOCK)

    return triton, loss_kernel, loss_bwd_kernel


_tickets = {}   # (device index, stream) -> int32 ticket, zero between calls


def _ticket(dev: torch.device) -> torch.Tensor:
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if key not in _tickets:
        _tickets[key] = torch.zeros((1,), device=dev, dtype=torch.int32)
    return _tickets[key]


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


def fused_tsdf_occ_loss_cuda(tsdf, occ, tsdf_t, occ_t, mask,
                             pos_weight: float = 1.0, out=None) -> torch.Tensor:
    """The forward kernel: (total, occ_loss, tsdf_loss) and the five sums
    (Σm, Σm·y, ...) into the first 8 floats of ``out`` (a contiguous float32
    device tensor, e.g. a row of the backward's ``(L, 8)`` tensor), or into
    a new 8-float tensor."""
    ins = [_flat_for_kernel(a) for a in (tsdf, occ, tsdf_t, occ_t, mask)]
    n = ins[0].numel()
    if n >= 2 ** 31 - _BLOCK * _MAX_PROGRAMS:
        raise ValueError("fused_tsdf_occ_loss: too many elements for int32 offsets")
    triton, loss_kernel, _ = _kernel()
    n_tiles = triton.cdiv(n, _BLOCK)
    nprog = max(1, min(n_tiles, _MAX_PROGRAMS))
    tiles_per_prog = triton.cdiv(n_tiles, nprog)
    dev = ins[0].device
    part = torch.empty((nprog, 8), device=dev, dtype=torch.float32)
    if out is None:
        out = torch.empty((8,), device=dev, dtype=torch.float32)
    elif not (out.dtype == torch.float32 and out.is_contiguous()
              and out.numel() >= 8 and out.device == dev):
        raise ValueError("fused_tsdf_occ_loss: out must be a contiguous float32 "
                         "tensor of at least 8 elements on the inputs' device")
    loss_kernel[(nprog,)](*ins, part, _ticket(dev), out, n, tiles_per_prog,
                          float(pos_weight), BLOCK=_BLOCK,
                          NP=max(16, triton.next_power_of_2(nprog)), num_warps=4)
    tracing.count("fused_loss.fwd_launches")
    return out


def fused_tsdf_occ_loss_bwd_cuda(levels, sums, g, pos_weight: float = 1.0):
    """The backward kernel over every level: [(d_tsdf, d_occ), ...],
    contiguous, in the predictions' dtypes.  ``levels`` holds each level's
    (tsdf, occ, tsdf_t, occ_t, mask); row i of ``sums`` (float32, (L, >= 5))
    is level i's forward output, whose columns 3 and 4 are (Σm, Σm·y); row i
    of ``g`` (L, 3) its cotangents.  Both stay on the device.  One launch
    per ``_BWD_LEVELS`` levels."""
    n_lv = len(levels)
    if sums.dim() != 2 or sums.shape[0] != n_lv or sums.shape[1] < 5 \
            or sums.dtype != torch.float32 or sums.stride(1) != 1:
        raise ValueError(f"fused_tsdf_occ_loss: sums must be float32 ({n_lv}, >= 5) "
                         f"with unit column stride, got {tuple(sums.shape)} {sums.dtype}")
    if tuple(g.shape) != (n_lv, 3):
        raise ValueError(f"fused_tsdf_occ_loss: g must be ({n_lv}, 3), got "
                         f"{tuple(g.shape)}")
    triton, _, loss_bwd_kernel = _kernel()
    g = g.to(torch.float32).contiguous()
    grads = []
    for first in range(0, n_lv, _BWD_LEVELS):
        args, starts, n_prog = [], [], 0
        for lv in levels[first:first + _BWD_LEVELS]:
            ins = [_flat_for_kernel(a) for a in lv]
            n = ins[0].numel()
            if n >= 2 ** 31 - _BWD_BLOCK:
                raise ValueError("fused_tsdf_occ_loss: too many elements for "
                                 "int32 offsets")
            d_t = torch.empty(lv[0].shape, device=lv[0].device, dtype=lv[0].dtype)
            d_x = torch.empty(lv[1].shape, device=lv[1].device, dtype=lv[1].dtype)
            grads.append((d_t, d_x))
            args += [*ins, d_t.view(-1), d_x.view(-1), n]
            starts.append(n_prog)
            n_prog += triton.cdiv(n, _BWD_BLOCK)
        # absent levels: the first level's pointers, an empty program range
        while len(starts) < _BWD_LEVELS:
            starts.append(n_prog)
            args += args[:7] + [0]
        loss_bwd_kernel[(max(1, n_prog),)](
            *args, starts[1], starts[2], sums[first:], sums.stride(0), g[first:],
            float(pos_weight), BLOCK=_BWD_BLOCK, num_warps=_BWD_WARPS)
        tracing.count("fused_loss.bwd_launches")
    return grads


class FusedTsdfOccLossLevels(torch.autograd.Function):
    """(total, occ_loss, tsdf_loss) of each level as one (L, 3) float32
    tensor, with the ``_bwd`` gradient for each level's two predictions.  The
    forward keeps each level's sums (Σm, Σm·y) that the backward needs, on
    the device; cotangents autograd does not supply arrive as zeros.  With
    a ``group`` the sums are the group's, all-reduced in one call."""

    @staticmethod
    def forward(ctx, pos_weight, group, *flat):
        levels = [flat[i:i + 5] for i in range(0, len(flat), 5)]
        if flat[0].device.type == "cuda":
            sums = torch.empty((len(levels), 8), device=flat[0].device,
                               dtype=torch.float32)
            for row, lv in zip(sums, levels):
                fused_tsdf_occ_loss_cuda(*lv, pos_weight=pos_weight, out=row)
        else:
            rows = []
            for lv in levels:
                s = partial_sums_plain(*lv)
                rows.append(torch.cat([torch.stack(_combine(s, pos_weight)), s]))
            sums = torch.stack(rows)
        if group is not None:
            raw = collectives.all_reduce(sums[:, 3:8].contiguous(), group)
            # one rank: the sums are its own, and so are the losses
            losses = (sums[:, :3] if collectives.group_size(group) == 1
                      else torch.stack(_combine(raw.T, pos_weight), 1))
            sums = torch.cat([losses, raw], 1)
        ctx.pos_weight = pos_weight
        ctx.save_for_backward(*flat, sums)
        return sums[:, :3]

    @staticmethod
    def backward(ctx, g):
        *flat, sums = ctx.saved_tensors
        levels = [flat[i:i + 5] for i in range(0, len(flat), 5)]
        if sums.device.type == "cuda":
            grads = fused_tsdf_occ_loss_bwd_cuda(levels, sums, g, ctx.pos_weight)
        else:
            grads = [fused_tsdf_occ_loss_bwd_plain(*lv, row[3:5], gl.float(),
                                                   ctx.pos_weight)
                     for lv, row, gl in zip(levels, sums, g)]
        return (None, None) + tuple(d for d_t, d_x in grads
                                     for d in (d_t, d_x, None, None, None))


def fused_tsdf_occ_loss_levels(levels, pos_weight: float = 1.0,
                               group=None) -> torch.Tensor:
    """Fused masked loss of several levels at once; returns an (L, 3) float32
    tensor whose row i is level i's (total, occ_loss, tsdf_loss),
    differentiable in each level's ``tsdf`` and ``occ``.

    ``levels`` is a sequence of (tsdf, occ, tsdf_t, occ_t, mask); the five
    tensors of a level have one shape, and every tensor lies on one CUDA
    device or on the CPU.  CUDA tensors launch the forward kernel once per
    level and the backward kernel once for all of them; CPU tensors take the
    plain versions.  ``group`` (a process group of data-parallel ranks, each
    with its own shard of the batch) makes every level's loss the group's:
    the sums all-reduced in one call before the combine and the backward.
    """
    levels = [tuple(lv) for lv in levels]
    if not levels or any(len(lv) != 5 for lv in levels):
        raise ValueError("fused_tsdf_occ_loss: levels must be a non-empty list "
                         "of (tsdf, occ, tsdf_t, occ_t, mask)")
    for lv in levels:
        if any(a.shape != lv[0].shape for a in lv):
            raise ValueError(f"fused_tsdf_occ_loss: shapes differ: "
                             f"{[tuple(a.shape) for a in lv]}")
    devs = {a.device.type for lv in levels for a in lv}
    if devs not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"fused_tsdf_occ_loss: inputs on {sorted(devs)}; "
                         "all must be on one CUDA device or all on the CPU")
    return FusedTsdfOccLossLevels.apply(float(pos_weight), group,
                                        *(a for lv in levels for a in lv))


def fused_tsdf_occ_loss(tsdf, occ, tsdf_t, occ_t, mask, pos_weight: float = 1.0,
                        group=None):
    """Fused masked loss of one level; returns (total, occ_loss, tsdf_loss) as
    0-d tensors, differentiable in ``tsdf`` and ``occ``: the levels' Function
    at L = 1."""
    losses = fused_tsdf_occ_loss_levels([(tsdf, occ, tsdf_t, occ_t, mask)],
                                        pos_weight, group)[0]
    return losses[0], losses[1], losses[2]
